"""Smoke test of the PyTorch/CUDA port on one GPU: the quickest proof that
``tpuddp_torch`` still builds its kernels and trains on the card.

    python chip_smoke.py

Phases, each printing one line (the first failure exits non-zero):

1. a CUDA device exists; print ``nvidia-smi``'s name and power limit;
2. build every kernel of the main path from the sources in the checkout
   (``fused_adam.cu``: its float32-moment and bf16-moment instantiations),
   and the host row gather (``data/_native/gather.cpp``, g++), each with its
   build seconds;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes and at odd ones (misaligned views, leaves of 1, 3 and
   4 elements, 100 leaves over three launches), and time it in turns with
   its plain version, beside the card's bound for the same work and the
   host's enqueue time: the float32 instantiation also beside
   ``torch.optim.Adam(fused=True)`` (a yardstick, never called by the port);
   the bf16 one has no PyTorch counterpart. The bf16 instantiation must
   agree bitwise on its moments with zero gradients (then both versions'
   float32 moments are b * m, rounded once, so any difference is a wrong
   element index, step count or salt in the rounding);
4. drive the main paths, each through the ``train_native`` worker
   in-process on ``cuda:0`` with the launch counts set to 0 just before it
   and read just after (the default pipeline: two ``PrefetchLoader`` threads
   and batches staged from pinned memory two ahead of the step):
   - ``tpuddp_torch/configs/cifar10_alexnet_h100.yaml``: AlexNet at 224 px,
     batch 128, float32, three epochs at ``scan_steps: auto`` (16 train
     steps, one chunk, and 6 eval batches, one group, per epoch on the
     synthetic CIFAR-10 stand-in, no checkpoint: epoch 1 is the chunk's
     eager warm-up, epoch 2 its capture, epoch 3 a replay): one
     float32-kernel launch per step, and epoch 1 at the float32 kernel's
     reference losses (2.9944 / 2.3076) to four decimals, so the float32
     instantiation did not move; the steady step is epoch 3's;
   - ``tpuddp_torch/configs/cifar10_alexnet_bf16_h100.yaml``: the same epochs
     with bfloat16 compute and bf16 Adam moments: one bf16-kernel launch per
     step, finite losses, its step beside the float32 one;
   - ``tpuddp_torch/configs/cifar10_toy_cnn_sync_bn.yaml``: three toy_cnn
     epochs with sync_bn at world 1: finite losses and BatchNorm buffers
     that moved;
5. drive the managed path (``train_accelerate``'s worker, in-process on
   ``cuda:0``, counts set to 0 just before each run and read just after):
   - "5 managed": one epoch of
     ``tpuddp_torch/configs/cifar10_alexnet_managed_h100.yaml`` (AlexNet at
     224 px, batch 128, float32, the synthetic stand-in): 16 steps, one
     float32-kernel launch per step, finite losses, 512 test rows evaluated
     by the process (the unprepared test loader), its step median beside
     the native one;
   - "5 managed accum": the same epoch with ``gradient_accumulation_steps:
     2``: 8 launches for 16 micro-batches;
   - "5 managed vs native": 3 AlexNet steps of each path from one state
     dict, no flip, the same dropout seed: parameters within 1e-5;
6. the host data path: one epoch of each native file of phase 4 at
   ``scan_steps: 1`` (one step per batch, the cadence whose synchronise
   ``pipeline: false`` adds) under ``pipeline: false``, the default
   pipeline and the default's staging without loader threads
   (``host_workers: 0``), in turns (false, default,
   no threads, no threads, default, false), each with its launches, the
   float32 ones at 2.9944 / 2.3076: step medians (steps 2-16) and the train
   pass's host stall per step; and the native row gather's ms per 128-row
   batch of a CIFAR-10-sized uint8 array beside numpy's, in turns;
7. resume at full width (AlexNet@224 b128 float32, ``checkpoint_epoch: 1``,
   in a temporary directory deleted afterwards; each file is 684 MB), for
   the native (``ckpt_{epoch}.npz``) and the managed (``state_{epoch}.npz``)
   path: 2 epochs straight against epoch 0 alone and a run with ``resume:
   true`` and ``keep_last: 1`` for epoch 1: epoch 1's losses equal, the final
   parameters and moments at max |dp| = 0, 16 float32-kernel launches in the
   resumed run, only ``*_1.npz`` kept; a truncated newest file is skipped for
   the one before it; the save and load seconds of one file;
8. the optimizers beside Adam (SGD, SGDW, LARS, LAMB and the global-norm
   clip, PyTorch ops on the card: the JAX package has no Pallas kernel for
   them), with weight decay 5e-4 and momentum 0.9:
   - "8 optimizer steps": each optimizer's 3 steps on AlexNet's 16 leaf
     shapes plus one all-zero leaf, from one seeded state, on the card
     against the same optimizer on the CPU: parameters within 1e-5, the
     LARS/LAMB trust ratios within 1e-6 relative, the zero leaf's ratio 1
     (the unscaled step; for LARS its first step is ``-lr * g`` bitwise);
     then the clip to 1.0 of a gradient whose norm is far above 1; each
     update's time on the card beside the bytes it must move;
   - "8 native <opt>": three native AlexNet float32 epochs per optimizer
     at ``scan_steps: auto`` (lars and lamb with ``clip_grad_norm: 1.0``):
     finite losses, no launch of either Adam kernel, epoch 3's replayed
     step beside the Adam float32 one of phase 4;
   - "8 managed lamb accum": the managed epoch of phase 5 with lamb,
     ``clip_grad_norm: 1.0`` and ``gradient_accumulation_steps: 2``: finite
     losses, 8 updates, no Adam-kernel launch;
   - "8 resume lars": phase 7's native check with lars (456 MB files:
     parameters and momentum), no Adam-kernel launch;
   - "8 digits": ``tpuddp_torch/configs/digits_h100.yaml`` as written
     (toy_cnn with sync_bn on the 1,797 real digit scans of
     ``tpuddp_torch/data/digits.npz``, batch 32, 10 epochs) through the
     native worker: finite losses, one launch per step, the accuracy;
9. the managed path's fused steps (``fuse_steps``; each flush of K steps one
   CUDA-graph replay, ``training/graphs.py``):
   - "9 graph vs eager": from one state, 3 flushes through graph replay
     against the same 3 through the eager queue (the reference,
     ``PreparedOptimizer._graph_replay = False``): toy_cnn on real digits at
     depth 32 with Adam (float32 and bf16 moments) and with LAMB, and
     AlexNet@224 b128 at depth 8 with flips and dropout; max |dp| over
     parameters, buffers and optimizer state, and the losses (expected
     bitwise; failing beyond 1e-5), one launch of the moments' kernel per
     update through the replays, 1 capture and 2 replays; and 6 flushes of
     32 toy_cnn steps taking turns between two signatures of one length (32
     rows under the mean criterion, 20 under the sum criterion): 2 captures
     and 4 replays, each flush replaying its own signature's graph;
   - "9 managed fused": ``tpuddp_torch/configs/managed_fused_h100.yaml`` as
     written (toy_cnn, real digits, 6 epochs, ``fuse_steps: auto`` = 32,
     checkpoints at epochs 0 and 5 in a temporary directory) with graph
     replay, the eager queue and ``fuse_steps: 1`` in turns (replay, eager,
     depth 1, depth 1, eager, replay): finite losses, the accuracy, 270
     launches for 270 updates, 2 captures and 10 replays, the capture
     seconds, whether the three give the same epoch rows, and each one's
     step median over epochs 2-6;
   - "9 fused resume": that configuration for 5 epochs, then resumed for
     the 6th, against 6 straight epochs: ``state_5.npz`` at max |dp| = 0;
   - "9 managed fused AlexNet": two managed AlexNet@224 b128 epochs at
     ``fuse_steps: 8`` with graph replay (1 capture, 3 replays), through
     the eager queue and at ``fuse_steps: 1``, in the same turns: each
     run's epoch-2 step median.

10. the native path's ``scan_steps`` (each chunk of K train steps and each
   group of K eval batches one CUDA-graph replay) and the managed
   evaluator's groups, on the same graph engine:
   - "10 native graph vs eager": from one state, 3 chunks through
     ``train_step_many`` replayed against the same 3 run eagerly (the
     reference, ``DistributedDataParallel._graph_replay = False``): toy_cnn
     with sync_bn on real digits at K = 45 (Adam, bf16-moment Adam, LARS),
     AlexNet@224 b128 at K = 8 with flips and dropout, and at A = 2; max
     |dp| over parameters, buffers and optimizer state and the sums
     (expected bitwise; failing beyond 1e-5), one launch per update counted
     on the card, 1 capture and 2 replays; and 3 eval groups of 8 digits
     batches through ``eval_step_many``;
   - "10 native digits": ``digits_h100.yaml`` as written at ``scan_steps:
     auto`` (45 train and 8 eval batches per dispatch) with replay, eagerly
     and at ``scan_steps: 1``, in turns (replay, eager, 1, 1, eager,
     replay): the accuracy, equal epoch rows, 450 launches, 1 capture and 9
     replays each for train and eval, the step median over epochs 3-10;
   - "10 native AlexNet": 3 epochs of ``cifar10_alexnet_h100.yaml`` at
     auto (K = 16 train, 6 eval) against ``scan_steps: 1``, in turns: equal
     epoch rows and the epoch-3 step medians;
   - "10 managed eval groups": ``managed_fused_h100.yaml``'s model after two
     fused epochs, its ``FusedEvaluator`` with groups (one of 8 batches,
     replayed from the third pass) against ``fuse_steps=1``, in turns: the
     sums bitwise and the ms per eval pass.

11. ZeRO-1 (``weight_update_sharding``: the update of this rank's shard of
   one flat parameter vector, one Adam launch of one row per update; at one
   card the shard is the whole vector and the collectives are skipped) and
   the space-to-depth stem (``alexnet_s2d``):
   - "11 fast file": ``tpuddp_torch/configs/cifar10_alexnet_fast_h100.yaml``
     (``configs/cifar10_alexnet_fast.yaml``'s block: alexnet_s2d, bf16
     compute and moments, ZeRO-1, ``scan_steps: auto``) for 3 epochs on the
     synthetic stand-in at 224 px: finite losses, one bf16-kernel launch
     per update, each launch a table of one row; then 3 chunks of 8 of its
     steps replayed against the same chunks run eagerly from one state
     (bitwise, failing beyond 1e-5);
   - "11 flat shard": the kernel's flat-shard calling form (one row of
     AlexNet's 57,044,810 elements) against its plain version per step from
     one state: p within 1e-5 of max(1, |p|) (a v of exactly 0 beside a
     non-zero m steps p by lr * m / eps), float32 moments within 1e-6; bf16
     moments each a bf16 neighbour of the plain unrounded moment, bitwise at
     zero gradients; at base 0 and at the half-vector base; and its time in turns
     with the plain version, the per-leaf launch over AlexNet's 16 leaves and
     (float32) ``torch.optim.Adam(fused=True)`` over the one flat tensor,
     beside its bound;
   - "11 ZeRO-1 vs replicated": 3 AlexNet float32 steps without the clip
     from one state through each path with and without ZeRO-1: bitwise
     (reported as max |dp|, failing beyond 1e-6);
   - "11 stem": ``alexnet_s2d`` against ``alexnet`` from one state (max |d
     logits| at 224 px, float32), and the fast file against itself with
     ``model: alexnet``, in turns (s2d, alexnet, alexnet, s2d; 3 epochs
     each, the first s2d turn the fast-file run above): epoch-3 step
     medians.

12. the gradient comm hooks (``training.comm_hook``: ``bf16``, ``bf16_ef``,
   ``int8_ef``, ``topk_ef``; plain PyTorch ops, the JAX package's are plain
   ``jnp`` code) at world 1, where the collective is the identity but the
   compression and the error-feedback residual run:
   - "12 hooks vs plain": one AlexNet float32 gradient and a non-zero
     residual from a seed through each hook's native exchange (five
     JAX-order buckets) and managed round trip (each parameter a bucket)
     on the card against the same port functions on the CPU: bf16 and
     int8 bitwise, topk kept vectors equal but where a bucket's top-k
     threshold ties; an all-zero bucket and a bucket with a NaN; each
     round trip (``comm_sync``) timed call by call (the median of 40, in
     turns with the plain sync's flatten and copy back);
   - "12 native hooks": 3 epochs of ``cifar10_alexnet_h100.yaml`` at
     ``scan_steps: auto`` per hook: one Adam launch per update, epoch 1
     within ``loss_parity_tol`` of 2.9944 / 2.3076 (int8_ef's train loss
     within the bound it gives topk_ef: see ``PARITY_AS``), the replayed
     step;
   - "12 graph vs eager": 3 AlexNet chunks of 8 with bf16_ef and topk_ef,
     replayed and eager from one state: bitwise, the residual included;
   - "12 managed hooks": 3 managed
     AlexNet flushes of 8 with int8_ef, replay against the eager queue:
     bitwise, the residual included;
   - "12 ZeRO-1 hooks": the fast file with bf16_ef for 3 epochs, and 3
     AlexNet float32 steps with bf16_ef, ZeRO-1 against the replicated
     step from one state: bitwise, residuals included;
   - "12 resume": ``digits_h100.yaml`` with int8_ef on both paths, epoch 1
     resumed against the straight run: every array equal.

13. the segmented-overlap step (``comm_overlap``, the native default
   ``auto``; ``training/step.py::SegmentedSync``: each backward segment's
   exchange issued from a gradient hook on a side stream as its gradients
   land), AlexNet@224 b128 float32 at ``bucket_cap_mb: 25`` (three
   segments):
   - "13 segmented vs barrier": per hook (``none`` and the four of phase
     12), 3 chunks of 4 steps from one state through the barrier step
     eagerly (the reference), the segmented step eagerly and replayed, and
     the barrier step replayed: max |d| over parameters, the last update's
     gradients, Adam's moments and the residual, which must be 0; every
     segment exchanged from inside the backward (the wrap's host counts);
     one Adam launch per update; then the two replayed wraps' chunks in
     turns (barrier, segmented, segmented, barrier; eight rounds): their
     step medians. Then one A = 2 run with int8_ef the same way (one
     round);
   - "13 stream overlap": for ``int8_ef``, one chunk of each wrap eagerly
     and one replayed under ``torch.profiler``: the device streams, the
     busiest one's busy ms (eagerly the backward's stream) and the others'
     (eagerly the side stream), and the ms in which the busiest and another
     ran kernels at once (not measured where the trace holds no device
     events);
   - "13 plan": the resolved ``comm_overlap_meta`` at 25 (3 segments) and
     at 250 MB (one segment: the barrier step, with the JAX package's
     reason).

14. the numerical guard (``training.guard``: a non-finite aggregated
   gradient makes the update a bitwise no-op, decided on the device; the
   Adam kernel's guarded calling form reads the verdict and the step count
   from device memory):
   - "14 guard kernel": for both moment types at AlexNet's 16 leaves, the
     guarded launch at device count 6 and verdict 1 bitwise the unguarded
     launch of step 7; at verdict 0 nothing written and one launch
     counted; against the guarded plain version within phase 3's bounds;
     timed in turns with the unguarded launch, the skipped launch (as a
     CUDA graph's replays: its device work is shorter than its host
     enqueue), the plain version and (float32)
     ``torch.optim.Adam(fused=True)``, beside the bound (28 B / 20 B per
     parameter);
   - "14 guard verdict": the verdict over one AlexNet gradient
     (``all_finite``: one ``aminmax`` pass a leaf) in turns with
     ``isfinite(leaf).all()`` a leaf, replayed from CUDA graphs and eagerly,
     beside reading the gradient once; both 1 on it, 0 with a NaN or an
     infinity;
   - "14 guard chunk": native AlexNet@224 b128 float32 with flips and
     dropout, guarded, 3 chunks of 8 whose last holds the step poisoned
     through ``$TPUDDP_FAULT=nan@step=19`` (a NaN sample weight), replayed
     (warm-up, capture, replay) against eager chunks, the eager one cut
     around the poisoned step: every array bitwise, counters (1, 0), the
     skipped step a no-op, one Adam launch per update; with ``comm_hook``
     none and bf16_ef (segmented, 3 segments: every segment's residual span
     armed and unchanged by the skip); then the guarded and an unguarded
     replayed wrap in turns: step medians;
   - "14 managed guard": 3 managed AlexNet flushes of 8 guarded, the last
     holding the poisoned step, replayed against the eager queue: bitwise,
     losses included, counters (1, 0);
   - "14 rollback": ``digits_h100.yaml`` guarded for 2 epochs with epoch
     1's last 4 steps poisoned (over ``max_consecutive_skips`` 3): one
     rollback event, epochs 0, 1, 1, and the redone epoch's row and final
     state equal to a run resumed from a copy of the same ``ckpt_0.npz``.

15. the ResNets (``configs/multihost.yaml``'s ``resnet18_small`` on one
   card; the Adam kernel's multi-table update: 62 leaves in 2 launch tables
   of 48 and 14 rows, ResNet-50's 161 in 4):
   - "15 resnet file": ``tpuddp_torch/configs/cifar10_resnet18_small_h100.yaml``
     (sync_bn, 32 px, b128, float32) on the synthetic stand-in, one epoch one
     step per batch and 3 epochs at ``scan_steps: auto`` (one 16-step chunk
     an epoch): finite losses, 2 launches per update counted by the kernel,
     the step medians; "15 resnet graph vs eager": 3 chunks of 8 replayed
     against the same chunks run eagerly from one state, bitwise
     (parameters, BatchNorm buffers, moments, sums);
   - "15 resnet managed vs native": 3 steps of each path from one state:
     bitwise, 6 launches each;
   - "15 resnet50": one epoch of the file at ``model: resnet50`` and
     ``resnet50_s2d``, 224 px, one step per batch, in turns (plain, s2d,
     s2d, plain): step medians, peak device memory, 4 launches per update;
   - "15 resnet50 adam": both kernels over ResNet-50's 161 leaves against
     the plain version per step from one state (p within 1e-5 of max(1,
     |p|), as phase 11; float32 moments 1e-6; bf16 by the neighbour rule,
     bitwise at zero gradients), 4 launches a step, timed in turns with the
     plain version and (float32) ``torch.optim.Adam(fused=True)``, beside
     the bound (28 B / 20 B a parameter);
   - "15 resnet guard": 3 guarded ``resnet18_small`` chunks of 8 with
     ``nan@step=19``, replayed and eager: the skipped update a bitwise no-op
     on parameters, moments and all 40 BatchNorm buffers, with both of its
     launch tables at verdict 0; replay bitwise eager, counters (1, 0);
   - "15 resnet overlap": ``int8_ef`` at ``bucket_cap_mb: 5`` (2 segments),
     3 chunks of 4, segmented (eager, replayed) and the replayed barrier
     step against the eager barrier step: max |d| 0.

16. the VGGs and the pretrained fine-tune (``training.pretrained_path``;
   the Adam kernel over VGG-16's 32 leaves, 134,301,514 parameters, in one
   launch):
   - "16 vgg16 file": ``cifar10_alexnet_h100.yaml`` at ``model: vgg16``
     (224 px, b128, float32), one epoch one step per batch: finite losses,
     one launch per update, the step median (steps 2-16), peak memory;
   - "16 vgg chunks": 3 chunks of 4 steps from one state with flips and
     dropout: ``vgg16``@224 eagerly and replayed (the replayed step is the
     last chunk's time over 4); ``vgg11`` at 32 px (the 1 -> 7 adaptive
     pool) and 64 px (2 -> 7, overlapping bins) eagerly twice and
     replayed: every run bitwise the first (the pool's backward has no
     atomics), one launch per update;
   - "16 vgg managed vs native": 3 ``vgg11``@32 steps of each path from one
     state: bitwise;
   - "16 pretrained": a 1000-class torchvision-layout AlexNet file written
     from a seed; loaded on the card before a step, the file's tensors
     bitwise but the head, 10x4096; one epoch of
     ``cifar10_alexnet_h100.yaml`` with ``pretrained_path`` through each
     entry point (files in a temporary directory deleted afterwards): the
     managed parameters bitwise the native ones; 1000-class ``vgg16`` and
     ``resnet18`` files load with their heads swapped;
   - "16 vgg16 adam": both kernels over VGG-16's 32 leaves against the plain
     version per step from one state (phase 15's bounds), timed in turns
     with the plain version and (float32) ``torch.optim.Adam(fused=True)``,
     beside the bound (28 B / 20 B a parameter).

17. ``configs/multihost.yaml`` whole (``tpuddp_torch/configs/
   multihost_h100.yaml``: its ``local.rendezvous`` over 2 hosts, and the
   hierarchical topology): the card's first world-2 runs.
   - "17 multihost": two host processes (``$TPUDDP_PROCESS_ID`` 0 and 1,
     each running every turn in order through ``train_native.main`` as
     ``python -m tpuddp_torch.train_native`` runs it, each turn its own
     ``out_dir`` per host) meet at a free ``127.0.0.1`` coordinator (one
     port a turn), one rank each on this card over Gloo
     (``$TPUDDP_BACKEND=gloo``: NCCL refuses two ranks on one GPU), at
     ``$TPUDDP_WORLD_SIZE=2`` = 2 hosts x 1 local, one synthetic epoch at
     ``scan_steps: 1`` (a CUDA graph cannot hold Gloo) and seed 0: ``flat``,
     ``hierarchical`` with hook ``none`` and with ``bf16_ef`` in turns
     (flat, none, bf16_ef, none, flat). Both ranks log the world and the
     split, host 0 alone writes the checkpoint, the history and the epoch
     line, each process counts 2 Adam launches per update (``resnet18_small``'s
     two tables); ``none``'s checkpoint bitwise flat's (a sum of two values),
     every repeated run bitwise its first, ``bf16_ef`` within
     ``loss_parity_tol`` of flat with a finite non-zero residual; the step
     medians (Gloo through the host, two ranks on one card: not an NCCL
     measurement);
   - "17 bytes": AlexNet's counted bytes of one reduction at world 8 (2 x
     4) and 16 (2 x 8) per hook, flat and hierarchical (intra-host,
     inter-host).

Every launch count is the kernel's own: block 0 of each launch adds one to
a word on the card, so a launch replayed from a CUDA graph counts as an
eager one does, and a graph that lost its Adam node would count none.

Then one JSON line with the fused steps' numbers, one with phase 10's, one
with phase 11's, one with phase 12's (with each hook's gradient bytes per
update on AlexNet at world 1 and, counted, at world 8), one with phase
13's, one with phase 14's, one with phase 15's, one with phase 16's, one with
phase 17's, one with the optimizers', one
with every kernel's
(each with its guarded calling form's numbers), the script's seconds, the
card's name and power limit again, and last
``{"ok": true, "device": {...}}``. Without a GPU, or
outside a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from functools import partial

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; no GPU", file=sys.stderr)
    sys.exit(1)

from tpuddp_torch import config as cfg_lib  # noqa: E402
from tpuddp_torch import optim  # noqa: E402
from tpuddp_torch.accelerate import Accelerator, FusedEvaluator, PreparedOptimizer  # noqa: E402
from tpuddp_torch.data import _native, load_datasets_for, norm_stats_for  # noqa: E402
from tpuddp_torch.data.transforms import make_eval_transform, make_train_augment  # noqa: E402
from tpuddp_torch.models import AlexNet, load_model  # noqa: E402
from tpuddp_torch.models.convert import JaxFlatOrder, flat_to_jax, jax_leaf_index, jax_sizes  # noqa: E402
from tpuddp_torch.models.pretrained import pretrained_from_config  # noqa: E402
from tpuddp_torch.nn import CrossEntropyLoss  # noqa: E402
from tpuddp_torch.nn.norm import BatchNorm, convert_sync_batchnorm  # noqa: E402
from tpuddp_torch.ops import fused_adam  # noqa: E402
from tpuddp_torch.optim import Adam  # noqa: E402
from tpuddp_torch.parallel import collectives, comm  # noqa: E402
from tpuddp_torch.parallel.ddp import DistributedDataParallel  # noqa: E402
from tpuddp_torch.parallel.spawn import run_ddp_training  # noqa: E402
from tpuddp_torch.resilience import faults  # noqa: E402
from tpuddp_torch.resilience import guard as guard_lib  # noqa: E402
from tpuddp_torch.train_accelerate import basic_accelerate_training  # noqa: E402
from tpuddp_torch.train_accelerate import build_training as managed_build  # noqa: E402
from tpuddp_torch.train_accelerate import train as managed_train  # noqa: E402
from tpuddp_torch.train_native import basic_ddp_training_loop, build_training, set_numerics  # noqa: E402
from tpuddp_torch.training import checkpoint as ckpt  # noqa: E402
from tpuddp_torch.training import graphs  # noqa: E402
from tpuddp_torch.training.loop import run_training_loop  # noqa: E402
from tpuddp_torch.training.step import comm_sync  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(ROOT, "tpuddp_torch", "configs")
SETTINGS = os.path.join(CONFIGS, "cifar10_alexnet_h100.yaml")
SETTINGS_BF16 = os.path.join(CONFIGS, "cifar10_alexnet_bf16_h100.yaml")
SETTINGS_TOY = os.path.join(CONFIGS, "cifar10_toy_cnn_sync_bn.yaml")
SETTINGS_MANAGED = os.path.join(CONFIGS, "cifar10_alexnet_managed_h100.yaml")
SETTINGS_FUSED = os.path.join(CONFIGS, "managed_fused_h100.yaml")
SETTINGS_DIGITS = os.path.join(CONFIGS, "digits_h100.yaml")
SETTINGS_FAST = os.path.join(CONFIGS, "cifar10_alexnet_fast_h100.yaml")
SETTINGS_RESNET = os.path.join(CONFIGS, "cifar10_resnet18_small_h100.yaml")

# Tolerances of the kernel against its plain version (IEEE float32 both;
# they differ only where the kernel fuses a multiply-add that the plain
# version rounds twice). bf16 moments: equal, or one bf16 step apart where
# those two float32 moments fall on two sides of a rounding threshold; such
# a step moves a later p update by about lr * 2^-8 = 4e-6, inside P_TOL.
P_TOL, MOMENT_TOL = 1e-5, 1e-6
# the managed and the native path from one state: the same kernels in the
# same order at world 1, so any difference beyond rounding is a fault
PATHS_TOL = 1e-5
ODD_SHAPES = [(37, 50), (5,), (700, 130)]
# csrc/fused_adam.cu's design: all leaves in one launch, 16-byte streaming
# accesses (its header says more)
DESIGN = "vec4-multi"
STEPS = 3
HP = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
# PR 2's float32 epoch on this synthetic stand-in (PERF.md section 6)
F32_LOSSES = (2.9944, 2.3076)
# the pipelines of phase 6, in the order of their runs: the synchronous A/B
# mode, the default, and the default's staging without loader threads
PIPELINE_TURNS = ("false", "default", "no threads", "no threads", "default", "false")
PIPELINES = {"default": None, "false": False, "no threads": {"host_workers": 0}}

# Published peaks (NVIDIA data sheets): memory bytes/s and float32 FLOP/s
# outside the tensor cores, by a substring of the card's name.
PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H200", 4.8e12, 67e12),
    ("H100", 3.35e12, 67e12),
)
ADAM_OPS_PER_ELEMENT = 14  # m: 3, v: 4, p: 7 (no weight decay)
# integer operations per bf16 moment: widen (shift), noise (multiply, add,
# mask), add to the bits, shift
ROUNDING_OPS_PER_MOMENT = 6
KERNEL_NAMES = {torch.float32: "fused_adam", torch.bfloat16: "fused_adam_bf16_moments"}
# phase 8: the optimizers beside Adam, their settings, and the learning rates
# of the step comparison (the epochs keep the settings file's 1e-3)
OPTIMIZERS = ("sgd", "sgdw", "lars", "lamb")
OPT_HP = dict(weight_decay=5e-4, momentum=0.9)
OPT_LR = {"sgd": 1e-2, "sgdw": 1e-2, "lars": 1.0, "lamb": 1e-3}
TRUST = ("lars", "lamb")
RATIO_RTOL = 1e-6
# bytes per parameter an update must move (each input read once, each
# output written once): p, g and the momentum buffer read, p and the buffer
# written; LAMB: p, g, m, v read, p, m, v written
OPT_BYTES = {"sgd": 20, "sgdw": 20, "lars": 20, "lamb": 28}
NO_LIBRARY_BF16 = (
    "no PyTorch call computes it: torch.optim.Adam(fused=True) keeps the moments "
    "in the parameter's dtype, and nothing in PyTorch rounds them to bf16 stochastically"
)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str):
    for key, bw, flops in PEAKS:
        if key in name:
            return bw, flops
    raise SystemExit(f"chip_smoke: no published peaks for card {name!r}")


def make_leaves(shapes, seed: int, misaligned: str = "", moments=torch.float32,
                zero_grad: bool = False):
    """(p, g, m, v) per leaf on the card; the tensors named in `misaligned`
    are views at storage offset 1 (4 bytes off 16-byte alignment for
    float32, 2 for bf16). float32 moments start at zero; bf16 ones at small
    non-zero values, so a zero gradient still moves them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    leaves = []
    for shape in shapes:
        leaf = [torch.randn(shape, generator=gen, device="cuda"),
                torch.zeros(shape, device="cuda") if zero_grad
                else torch.randn(shape, generator=gen, device="cuda")]
        if moments == torch.float32:
            leaf += [torch.zeros(shape, device="cuda"), torch.zeros(shape, device="cuda")]
        else:
            leaf += [(torch.randn(shape, generator=gen, device="cuda") * 1e-2).to(moments),
                     (torch.rand(shape, generator=gen, device="cuda") * 1e-3).to(moments)]
        for i, name in enumerate("pgmv"):
            if name in misaligned:
                t = leaf[i]
                view = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")[1:]
                leaf[i] = view.view(shape).copy_(t)
        leaves.append(tuple(leaf))
    return leaves


def clone(leaves):
    return [tuple(t.clone() for t in leaf) for leaf in leaves]


def step_counts(t, n_leaves):
    """Per-leaf step counts: leaf i at step t + i % 3, as parameters whose
    step counts differ."""
    return [t + i % 3 for i in range(n_leaves)]


def leaf_indices(n_leaves):
    return [(7 * i + 3) % 50 for i in range(n_leaves)]


def kernel_step(wrapper, leaves, steps, weight_decay):
    ps, gs, ms, vs = (list(x) for x in zip(*leaves))
    bcs = [fused_adam.bias_corrections(s, HP["betas"]) for s in steps]
    wrapper(ps, gs, ms, vs, bc1s=[b[0] for b in bcs], bc2s=[b[1] for b in bcs],
            steps=steps, leaves=leaf_indices(len(leaves)), weight_decay=weight_decay, **HP)


def plain_step(leaves, steps, weight_decay):
    for (p, g, m, v), s, k in zip(leaves, steps, leaf_indices(len(leaves))):
        bc1, bc2 = fused_adam.bias_corrections(s, HP["betas"])
        fused_adam.adam_update_reference(p, g, m, v, weight_decay=weight_decay,
                                         bc1=bc1, bc2=bc2, step=s, leaf=k, **HP)


def max_diffs(a, b, p_relative: bool = False):
    """max |dp|, max |dm|, max |dv| over the leaves, the moments as float32;
    with ``p_relative`` max |dp| / max(1, |p|) (phase 11's bound: a v of
    exactly 0 beside a non-zero m steps p by lr * m / eps)."""
    def dp(x, y):
        d = (x[0] - y[0]).abs()
        return d / y[0].abs().clamp_min(1.0) if p_relative else d

    return [max(float(dp(x, y).max()) for x, y in zip(a, b))] + [
        max(float((x[i].float() - y[i].float()).abs().max()) for x, y in zip(a, b))
        for i in (2, 3)  # m, v
    ]


def f32_moments(leaf, weight_decay):
    """The plain version's unrounded float32 moments of one step from the
    leaf's state, each with the slack within which the kernel's may differ:
    its fused multiply-adds round once where the plain version rounds twice,
    which moves a moment by a few float32 ulps of the largest term; 2^-20
    of the terms' magnitudes covers them eight times over."""
    p, g, m, v = leaf
    b1, b2 = HP["betas"]
    if weight_decay:
        g = g + weight_decay * p
    m_terms = (b1 * m.float()).abs() + ((1 - b1) * g).abs()
    v_terms = (b2 * v.float()).abs() + ((1 - b2) * g * g).abs()
    m32 = b1 * m.float() + (1 - b1) * g
    v32 = b2 * v.float() + (1 - b2) * (g * g)
    return (m32, (m_terms + m32.abs()) * 2.0**-20), (v32, (v_terms + v32.abs()) * 2.0**-20)


def bf16_moment_check(kern, plain, before, weight_decay):
    """(moments outside their bounds, moments the two versions store
    differently): each kernel moment must be a bf16 neighbour of a float32
    value within the slack of the plain version's unrounded moment."""
    outside = apart = 0
    for k, pl, b in zip(kern, plain, before):
        for i, (x32, slack) in zip((2, 3), f32_moments(b, weight_decay)):
            low, _ = fused_adam.bf16_neighbours(x32 - slack)
            _, high = fused_adam.bf16_neighbours(x32 + slack)
            got = k[i].float()
            outside += int(((got < low) | (got > high)).sum())
            apart += int((k[i].view(torch.int16) != pl[i].view(torch.int16)).sum())
    return outside, apart


def time_ms(fn, iters: int = 20, warmup: int = 3):
    """(device ms, enqueue ms) per call: CUDA events around `iters` calls,
    and the host clock around the same enqueues without synchronising. When
    the two are close, the host sets the pace."""
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / iters
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters, enqueue_ms


def graph_ms(fn, iters: int = 20):
    """Device ms per call of ``fn`` captured into a CUDA graph and replayed
    ``iters`` times between CUDA events: for work shorter than its host
    enqueue, which an eager timing would measure instead."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, iters)[0]


def compare_cases(alexnet_shapes):
    chunk = fused_adam.CHUNK
    hundred = [(1 + (i * 7919) % 40000,) for i in range(97)]
    hundred += [(chunk - 1,), (chunk,), (chunk + 1,)]
    return [
        ("AlexNet", alexnet_shapes, "", 0.0),
        ("odd shapes", ODD_SHAPES, "", 1e-2),
        ("odd shapes", ODD_SHAPES, "", 0.0),
        *[(f"odd shapes, {t} a misaligned view", ODD_SHAPES, t, 1e-2) for t in "pgmv"],
        ("sizes 1, 3, 4", [(1,), (3,), (4,)], "", 0.0),
        ("100 leaves", hundred, "", 1e-2),
    ]


def compare(wrapper, cases, alexnet_shapes, tag: str = "3 compare", p_relative: bool = False):
    """Phase 3: `wrapper`'s kernel against the plain version over the
    cases, 3 steps each; returns max |dp| over them. Before each step the
    plain version takes the kernel's state, so each step is held from the
    same inputs: p within P_TOL, float32 moments within MOMENT_TOL. A bf16
    moment may differ from the plain version's wherever the two float32
    moments straddle a rounding threshold (or, where 0.9 m + 0.1 g cancels,
    zero): it must be a bf16 neighbour of a value within float32 rounding
    of the plain version's unrounded moment. bf16 moments also run the
    zero-gradient cases, where both float32 moments are b * m, rounded once,
    and the stored ones must be bitwise equal: any difference is a wrong
    element index, step count or salt."""
    bf16 = wrapper.moment_dtype == torch.bfloat16
    runs = [(*c, False) for c in cases]
    if bf16:
        runs += [(f"zero gradients, {cases[0][0]}", alexnet_shapes, "", 0.0, True),
                 ("zero gradients, odd shapes", ODD_SHAPES + [(1,), (3,), (4097,)], "", 0.0, True)]
    errs = []
    for label, shapes, misaligned, wd, zero_grad in runs:
        kern = make_leaves(shapes, seed=len(shapes), misaligned=misaligned,
                           moments=wrapper.moment_dtype, zero_grad=zero_grad)
        launches = wrapper.launches
        dp = dm = dv = 0.0
        outside = apart = 0
        for t in range(1, STEPS + 1):
            before, plain = clone(kern), clone(kern)
            steps = step_counts(t, len(shapes))
            kernel_step(wrapper, kern, steps, wd)
            plain_step(plain, steps, wd)
            torch.cuda.synchronize()
            dp, dm, dv = (max(a, b) for a, b in zip((dp, dm, dv), max_diffs(kern, plain, p_relative)))
            if bf16:
                out, n_apart = bf16_moment_check(kern, plain, before, wd)
                outside, apart = outside + out, apart + n_apart
            del before, plain
        launches = wrapper.launches - launches
        want = STEPS * math.ceil(len(shapes) / fused_adam.MAX_LEAVES)
        detail = (f"max|dp|{'/max(1,|p|)' if p_relative else ''}={dp:.3g} max|dm|={dm:.3g} "
                  f"max|dv|={dv:.3g}")
        if bf16:
            n = STEPS * sum(2 * math.prod(s) for s in shapes)
            moments_ok = outside == 0 and (apart == 0 or not zero_grad)
            detail += (f"; moments stored differently (each a bf16 neighbour of the plain "
                       f"float32 moment within rounding): {apart} of {n} moment-steps"
                       + (" (bitwise)" if zero_grad else "") + f", {outside} outside their bounds")
        else:
            moments_ok = dm <= MOMENT_TOL and dv <= MOMENT_TOL
        name = KERNEL_NAMES[wrapper.moment_dtype]
        if not (dp <= P_TOL and moments_ok and launches == want):
            raise SystemExit(
                f"chip_smoke: {name} disagrees with its plain version on {label} "
                f"({len(shapes)} leaves, wd={wd}): {detail}; {launches} launches "
                f"(expected {want})"
            )
        errs.append(dp)
        phase(tag, f"{name} vs plain, {label}: {len(shapes)} leaves, wd={wd}, "
              f"{STEPS} steps, {launches} launches: {detail}")
    return max(errs)


def time_kernel(wrapper, alexnet_shapes, bw, flops, label: str = "AlexNet", tag: str = "3 time"):
    """Phase 3: one AlexNet Adam step of `wrapper`'s kernel timed in turns
    with the plain version and, for float32 moments, with
    ``torch.optim.Adam(fused=True)``; beside the bound for the bytes it must
    move and the operations it must do."""
    bf16 = wrapper.moment_dtype == torch.bfloat16
    n_params = sum(math.prod(s) for s in alexnet_shapes)
    leaves = make_leaves(alexnet_shapes, seed=1, moments=wrapper.moment_dtype)
    steps = step_counts(1, len(alexnet_shapes))
    ps, gs, ms, vs = (list(x) for x in zip(*leaves))
    bcs = [fused_adam.bias_corrections(s, HP["betas"]) for s in steps]
    fns = {
        "plain": partial(plain_step, leaves, steps, 0.0),
        "kernel": partial(wrapper, ps, gs, ms, vs, bc1s=[b[0] for b in bcs],
                          bc2s=[b[1] for b in bcs], steps=steps,
                          leaves=leaf_indices(len(leaves)), weight_decay=0.0, **HP),
    }
    # in turns on one card: plain, kernel, [library, library,] kernel, plain
    order = ("plain", "kernel", "kernel", "plain")
    if not bf16:
        params = [torch.nn.Parameter(p.clone()) for p in ps]
        for prm, g in zip(params, gs):
            prm.grad = g.clone()
        fns["library"] = torch.optim.Adam(params, fused=True, **HP).step
        order = ("plain", "kernel", "library", "library", "kernel", "plain")
    runs = {k: [] for k in fns}
    for k in order:
        runs[k].append(time_ms(fns[k]))
    best = {k: min(r) for k, r in runs.items()}
    (kernel_ms, kernel_enq), (plain_ms, _) = best["kernel"], best["plain"]
    # read p, g, m, v; write p, m, v
    nbytes = (3 * 4 + 4 * ms[0].element_size()) * n_params
    bytes_ms = nbytes / bw * 1e3
    ops = ADAM_OPS_PER_ELEMENT + (2 * ROUNDING_OPS_PER_MOMENT if bf16 else 0)
    ops_ms = ops * n_params / flops * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    library_ms = best["library"][0] if "library" in best else None
    each = " ".join(f"{k}=" + ",".join(f"{t_ms:.4f}" for t_ms, _ in runs[k]) for k in fns)
    library = ""
    if library_ms is not None:
        library = (f"library_ms={library_ms:.4f} library_enqueue_ms={best['library'][1]:.4f} "
                   f"(kernel/library {kernel_ms / library_ms:.3f}) ")
    phase(tag, f"one {label} Adam step, {KERNEL_NAMES[wrapper.moment_dtype]} "
          f"({len(alexnet_shapes)} leaves, {n_params} params, {nbytes / 1e9:.3f} GB), best of "
          f"two in turns: kernel_ms={kernel_ms:.4f} enqueue_ms={kernel_enq:.4f} {library}"
          f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({nbytes / kernel_ms / 1e6:.0f} "
          f"GB/s, {100 * bound_ms / kernel_ms:.1f}% of bound); each run: {each}")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, enqueue_ms=kernel_enq,
                bound_ms=bound_ms, bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def training_for(path: str):
    settings = cfg_lib.load_settings(path)
    cfg_lib.check_settings(settings)
    training = cfg_lib.training_config(settings)
    # the synthetic stand-in by name, so a CIFAR-10 staged under data_root
    # cannot change the epoch's size; no save_dir, so no checkpoint is written
    training.update(num_epochs=1, dataset="synthetic", synthetic_n=(2048, 512))
    return settings, training


def reset_counts():
    for k in fused_adam.kernels.values():
        k.reset_launches()


def native_run(path: str, overrides=None, save_dir=None):
    """The native worker on the settings at `path` (one epoch unless
    `overrides` says otherwise), counts set to 0 just before it and read
    just after: ``(history, wall seconds, launches by kernel symbol)``."""
    settings, training = training_for(path)
    training.update(overrides or {})
    reset_counts()
    t0 = time.perf_counter()
    history = run_ddp_training(
        partial(basic_ddp_training_loop, training=training, device="cuda"),
        1, save_dir, cfg_lib.optional_args_from(settings), backend="cuda",
    )
    torch.cuda.synchronize()
    return history, time.perf_counter() - t0, {k.symbol: k.launches for k in fused_adam.kernels.values()}


def check_epochs(label: str, history, launches, wrapper, f32_losses: bool):
    """Every epoch's row: 16 steps, finite losses, every sample; one launch
    of `wrapper`'s kernel per step over the run and none of another; with
    `f32_losses` the first epoch at the float32 reference losses
    (F32_LOSSES). Returns the run's steps."""
    steps = sum(len(r["step_ms"]) for r in history)
    others = sum(n for sym, n in launches.items() if sym != wrapper.symbol)
    checks = {
        "16 train steps an epoch": all(len(r["step_ms"]) == 16 for r in history),
        "1 launch per step": launches[wrapper.symbol] == steps and others == 0,
        "finite losses": all(math.isfinite(r[k]) for r in history for k in ("train_loss", "test_loss")),
        "2048 train / 512 test samples": all(
            (r["train_samples"], r["test_samples"]) == (2048, 512) for r in history),
    }
    if f32_losses:
        checks["PR 2's losses 2.9944 / 2.3076"] = (
            round(history[0]["train_loss"], 4), round(history[0]["test_loss"], 4)) == F32_LOSSES
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: {label} failed {failed}: launches={launches}, history={history}")
    return steps


def alexnet_epoch(label: str, path: str, wrapper):
    """Three AlexNet epochs of the settings at `path` at its ``scan_steps:
    auto`` (one 16-step chunk per epoch: the eager warm-up, the capture,
    a replay); every step must launch `wrapper`'s kernel once and no other
    kernel. The steady step is epoch 3's, the replayed chunk's time over
    its 16 steps."""
    history, wall_s, launches = native_run(path, {"num_epochs": 3})
    steps = check_epochs(label, history, launches, wrapper, wrapper is fused_adam.kernel)
    first, last = history[0], history[-1]
    steady = statistics.median(last["step_ms"])
    phase("4 main path", f"{label}, 3 epochs at scan_steps auto (one 16-step chunk each): {steps} steps, "
          f"{wrapper.symbol} launches={wrapper.launches} ({wrapper.launches // steps}/step), epoch 1 "
          f"train_loss={first['train_loss']:.4f} test_loss={first['test_loss']:.4f}; step_ms epoch 1 (the "
          f"eager warm-up, set-up included) {first['step_ms'][0]:.2f}, epoch 3 (replayed) {steady:.2f}; "
          f"{128 * 1e3 / steady:.0f} img/s; host stall {last['host_stall_s'] * 1e3 / 16:.3f} ms/step in "
          f"epoch 3; wall {wall_s:.2f} s")
    return wrapper.launches, steps, steady


def _toy_cnn_worker(rank, world_size, save_dir, optional_args, training):
    """basic_ddp_training_loop's two calls, keeping the model to read its
    BatchNorm buffers."""
    ddp, train_loader, test_loader, base_seed = build_training(rank, world_size, training, "cuda")
    norms = [m for m in ddp.model.modules() if isinstance(m, BatchNorm)]
    before = [(m.running_mean.clone(), m.running_var.clone()) for m in norms]
    history = run_training_loop(
        ddp, train_loader, test_loader, save_dir, num_epochs=training["num_epochs"],
        checkpoint_epoch=training["checkpoint_epoch"], base_seed=base_seed,
    )
    moved = all(
        not torch.equal(m.running_mean, mean) and not torch.equal(m.running_var, var)
        for m, (mean, var) in zip(norms, before)
    )
    return history, [m.sync for m in norms], moved


def toy_cnn_epoch():
    settings, training = training_for(SETTINGS_TOY)
    training["num_epochs"] = 3
    reset_counts()
    history, syncs, moved = run_ddp_training(
        partial(_toy_cnn_worker, training=training), 1, None,
        cfg_lib.optional_args_from(settings), backend="cuda",
    )
    torch.cuda.synchronize()
    row = history[-1]
    steps = sum(len(r["step_ms"]) for r in history)
    checks = {
        "2 synced BatchNorms": syncs == [True, True],
        "finite losses": all(math.isfinite(r[k]) for r in history for k in ("train_loss", "test_loss")),
        "BatchNorm buffers moved": moved,
        "1 launch per step": (fused_adam.kernel.launches == steps == 48
                              and fused_adam.kernels[torch.bfloat16].launches == 0),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: toy_cnn sync-BN epoch failed {failed}: history={history}")
    phase("4 toy_cnn", f"toy_cnn@32 b128 sync_bn, 3 epochs at world 1, scan_steps auto (one 16-step chunk "
          f"each): {steps} steps, fused_adam launches={fused_adam.kernel.launches}, epoch 3 train_loss="
          f"{row['train_loss']:.4f} test_loss={row['test_loss']:.4f}, BatchNorm buffers moved; step_ms "
          f"epoch 3 (replayed) {statistics.median(row['step_ms']):.2f}")
    return fused_adam.kernel.launches


def managed_epoch(label: str, accum: int, overrides=None, tag: str = "5 managed"):
    """One managed AlexNet epoch (train_accelerate's worker) with
    ``gradient_accumulation_steps = accum``: ``16 / accum`` updates, one
    float32-kernel launch per update (none with `overrides` naming another
    optimizer than Adam)."""
    settings, training = training_for(SETTINGS_MANAGED)
    training.update(overrides or {}, gradient_accumulation_steps=accum)
    adam = training["optimizer"] == "adam"
    reset_counts()
    t0 = time.perf_counter()
    history = run_ddp_training(
        partial(basic_accelerate_training, training=training, device="cuda"),
        1, None, cfg_lib.optional_args_from(settings), backend="cuda",
    )
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    row = history[-1]
    steps = len(row["step_ms"])
    launches = fused_adam.kernel.launches
    checks = {
        "16 train steps": steps == 16,
        f"{16 // accum} updates, {'1 launch each' if adam else 'no Adam-kernel launch'}": (
            row["updates"] == 16 // accum and launches == (row["updates"] if adam else 0)
            and fused_adam.kernels[torch.bfloat16].launches == 0),
        "finite losses": all(math.isfinite(row[k]) for k in ("train_loss", "test_loss")),
        "2048 train rows, 512 test rows on the process": (
            (row["train_samples"], row["test_samples"]) == (2048, 512)),
        "managed history row": (row["api"], row["grad_accumulation"], row["fuse_steps"]) == (
            "managed", accum, 1),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: managed {label} failed {failed}: launches={launches}, row={row}")
    steady = statistics.median(row["step_ms"][1:])
    phase(tag + (f" accum" if accum > 1 else ""),
          f"{label}, 1 epoch: {steps} steps, {row['updates']} updates, fused_adam launches="
          f"{launches}, train_loss={row['train_loss']:.4f} test_loss={row['test_loss']:.4f} "
          f"test_accuracy={row['test_accuracy']:.2f}% on {row['test_samples']} test rows; step_ms "
          f"first={row['step_ms'][0]:.2f} median(2..{steps})={steady:.2f} "
          f"min={min(row['step_ms'][1:]):.2f}; epoch wall {wall_s:.2f} s")
    return launches, steady


def managed_vs_native(name: str = "alexnet", size=224, sync_bn: bool = False,
                      tag: str = "5 managed vs native"):
    """3 steps of the registry model ``name`` (AlexNet by default) through
    each API from one state dict, no flip, the dropout generator seeded
    alike: the parameters (and buffers) after them agree. Returns each
    path's Adam launches."""
    torch.manual_seed(0)
    init = {k: v.clone() for k, v in load_model(name, 10).state_dict().items()}
    gen = torch.Generator().manual_seed(1)
    batches = [(torch.randint(0, 256, (128, 32, 32, 3), dtype=torch.uint8, generator=gen).numpy(),
                torch.randint(0, 10, (128,), generator=gen).numpy(),
                torch.ones(128).numpy()) for _ in range(3)]
    augment = make_train_augment(size=size, flip=False)

    def fresh():
        model = load_model(name, 10)
        model.load_state_dict(init)
        if sync_bn:
            convert_sync_batchnorm(model)
        return model.cuda()

    native = fresh()
    ddp = DistributedDataParallel(native, Adam(native.parameters(), lr=1e-3), CrossEntropyLoss(),
                                  augment=augment, device="cuda")
    torch.cuda.manual_seed(7)
    reset_counts()
    for batch in batches:
        ddp.train_step(batch)
    launches = {"native": fused_adam.kernel.launches}
    reset_counts()

    acc = Accelerator(seed=0, augment=augment, device="cuda")
    module = fresh()
    model, opt = acc.prepare(module, Adam(module.parameters(), lr=1e-3))
    torch.cuda.manual_seed(7)  # after the Accelerator seeded its process
    losses = []
    for x, y, w in batches:
        opt.zero_grad()
        loss = CrossEntropyLoss()(model(x), y, w)
        acc.backward(loss)
        opt.step()
        losses.append(loss.item())
    torch.cuda.synchronize()
    launches["managed"] = fused_adam.kernel.launches
    diff = max(float((a - b).abs().max()) for a, b in
               zip(model.module.state_dict().values(), native.state_dict().values()))
    if not diff <= PATHS_TOL or not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"chip_smoke: managed and native {name} disagree after 3 steps: "
                         f"max|dp|={diff:.3g} (tolerance {PATHS_TOL}), losses {losses}")
    phase(tag, f"3 {name}@{size or 32} b128 steps through each API from one state: "
          f"max|dp|={diff:.3g} over parameters and buffers (tolerance {PATHS_TOL}"
          f"{', bitwise' if diff == 0 else ''}); managed losses "
          + ", ".join(f"{v:.4f}" for v in losses) + f"; Adam launches {launches}")
    return dict(max_abs_dp=diff, losses=losses, launches=launches)


def pipeline_turns(label: str, path: str, wrapper, f32_losses: bool):
    """Phase 6: epochs of the settings at `path` under ``pipeline: false``
    and the default pipeline in turns, one step per batch (``scan_steps:
    1``: what ``pipeline: false`` adds is a synchronise per step); returns
    the launches by pipeline."""
    medians = {k: [] for k in PIPELINES}
    stalls = {k: [] for k in PIPELINES}
    launches = {k: 0 for k in PIPELINES}
    for mode in PIPELINE_TURNS:
        history, _, counts = native_run(path, {"pipeline": PIPELINES[mode], "scan_steps": 1})
        row = history[-1]
        steps = check_epochs(f"{label}, pipeline {mode}", history, counts, wrapper, f32_losses)
        medians[mode].append(statistics.median(row["step_ms"][1:]))
        stalls[mode].append(row["host_stall_s"] * 1e3 / steps)
        launches[mode] += counts[wrapper.symbol]
    fmt = lambda xs, d: ", ".join(f"{x:.{d}f}" for x in xs)
    ratio = lambda k: statistics.median(medians[k]) / statistics.median(medians["false"])
    phase("6 data path", f"{label}, turns {'/'.join(PIPELINE_TURNS)}: step median(2..16) ms "
          + "; ".join(f"{k} [{fmt(medians[k], 2)}]" for k in PIPELINES)
          + f"; ratio to false: default {ratio('default'):.3f}, no threads "
          f"{ratio('no threads'):.3f}; host stall ms/step "
          + "; ".join(f"{k} [{fmt(stalls[k], 3)}]" for k in PIPELINES)
          + f"; launches {launches}" + ("; losses 2.9944 / 2.3076 in every run" if f32_losses else ""))
    return launches


def gather_turns(batches: int = 200):
    """Phase 6: the native row gather against numpy's fancy indexing, 128
    rows per batch out of a CIFAR-10-sized uint8 array (50,000 x 32x32x3),
    in turns (numpy, native, native, numpy), best of two."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(50000, 32, 32, 3), dtype=np.uint8)
    index = [rng.integers(0, len(images), 128) for _ in range(batches)]
    fns = {"numpy": lambda idx: images[idx],
           "native": lambda idx: _native.gather_rows(images, idx, pad_rows=128)}
    if not np.array_equal(fns["numpy"](index[0]), fns["native"](index[0])):
        raise SystemExit("chip_smoke: the native gather disagrees with numpy")
    runs = {k: [] for k in fns}
    for k in ("numpy", "native", "native", "numpy"):
        t0 = time.perf_counter()
        for idx in index:
            fns[k](idx)
        runs[k].append((time.perf_counter() - t0) * 1e3 / batches)
    phase("6 gather", f"128-row uint8 batch of 32x32x3 rows from 50,000 ({128 * 3072} B), {batches} "
          f"batches per run, in turns: native {min(runs['native']):.4f} ms vs numpy "
          f"{min(runs['numpy']):.4f} ms (runs native {runs['native']}, numpy {runs['numpy']})")


def _arrays(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def resume_check(kind: str, root: str, overrides=None, tag: str = "7 resume"):
    """Phase 7 for one path (phase 8 with `overrides` naming another
    optimizer): 2 epochs straight against epoch 0 and a resumed epoch 1
    (``keep_last: 1``); a truncated newest file skipped; the save and load
    seconds. Returns the resumed run's float32-kernel launches."""
    overrides = dict(overrides or {})
    adam = overrides.get("optimizer", "adam") == "adam"
    layout = ckpt.NATIVE if kind == "native" else ckpt.MANAGED
    prefix = ckpt.PREFIX[layout]
    path = SETTINGS if kind == "native" else SETTINGS_MANAGED
    worker = basic_ddp_training_loop if kind == "native" else basic_accelerate_training
    straight, resumed = os.path.join(root, kind, "straight"), os.path.join(root, kind, "resumed")

    def run(save_dir, **more):
        settings, training = training_for(path)
        training.update(checkpoint_epoch=1, **overrides, **more)
        os.makedirs(save_dir, exist_ok=True)
        reset_counts()
        history = run_ddp_training(partial(worker, training=training, device="cuda"), 1,
                                   save_dir, cfg_lib.optional_args_from(settings), backend="cuda")
        torch.cuda.synchronize()
        return history, {k.symbol: k.launches for k in fused_adam.kernels.values()}

    whole, _ = run(straight, num_epochs=2)
    run(resumed, num_epochs=1)
    t0 = time.perf_counter()
    again, launches = run(resumed, num_epochs=2, resume=True, keep_last=1)
    resumed_s = time.perf_counter() - t0
    a, b = _arrays(os.path.join(straight, f"{prefix}_1.npz")), _arrays(os.path.join(resumed, f"{prefix}_1.npz"))
    dp = max((float(np.abs(a[k].astype(np.float64) - b[k].astype(np.float64)).max())
              for k in a if a[k].dtype.kind == "f"), default=math.inf)
    kept = sorted(f for f in os.listdir(resumed) if f.startswith(f"{prefix}_"))
    checks = {
        "epoch 1 resumed alone": [r["epoch"] for r in again] == [1],
        "epoch 1's losses equal": (again[0]["train_loss"], again[0]["test_loss"]) == (
            whole[1]["train_loss"], whole[1]["test_loss"]),
        "max |dp| = 0 over parameters and moments": dp == 0.0,
        "every array equal": sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a),
        ("16 float32-kernel launches in the resumed run" if adam else "no Adam-kernel launch"): (
            launches[fused_adam.kernel.symbol] == (16 if adam else 0)
            and sum(launches.values()) == launches[fused_adam.kernel.symbol]),
        f"keep_last 1 kept {prefix}_1.npz alone": kept == [f"{prefix}_1.npz", f"{prefix}_1.npz.sha256"],
    }
    if kind == "native" and adam:
        checks["epoch 0 at 2.9944 / 2.3076"] = (
            round(whole[0]["train_loss"], 4), round(whole[0]["test_loss"], 4)) == F32_LOSSES
    del a, b
    newest = os.path.join(straight, f"{prefix}_1.npz")
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    model = AlexNet(num_classes=10).cuda()
    opt = cfg_lib.optimizer_from(training_for(path)[1] | overrides, model.parameters())
    t0 = time.perf_counter()
    next_epoch, meta = ckpt.restore_latest(straight, model, opt, layout=layout)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    checks["truncated newest skipped for the one before"] = (next_epoch, meta["epoch"]) == (1, 0)
    states = list(opt.state.values())
    checks["restored optimizer state on the card, float32, contiguous, step 16 where kept"] = (
        len(states) == 16 and all(
            t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()
            for st in states for t in st.values() if torch.is_tensor(t))
        and all(st.get("step", 16) == 16 for st in states))
    keys = {} if layout == ckpt.NATIVE else {"keys": (meta["rng_key"], meta["bwd_key"])}
    t0 = time.perf_counter()
    saved = ckpt.save_on_main(os.path.join(root, kind, "timed"), 0, model, opt, 0, layout=layout,
                              **keys)
    save_s = time.perf_counter() - t0
    size_mb = os.path.getsize(saved) / 1e6
    shutil.rmtree(os.path.join(root, kind))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: {tag} ({kind}) failed {failed}: max|dp|={dp}, kept={kept}, "
                         f"launches={launches}, straight={whole}, resumed={again}")
    state_name = "moments" if adam else "optimizer state"
    phase(tag, f"{kind} AlexNet@224 b128 float32{' ' + str(overrides) if overrides else ''}: epoch 1 "
          f"resumed from {prefix}_0.npz (train_loss={again[0]['train_loss']:.4f} "
          f"test_loss={again[0]['test_loss']:.4f}, equal to the straight run), max|dp|=0 over "
          f"parameters and {state_name}, {launches[fused_adam.kernel.symbol]} fused_adam launches, "
          f"kept {kept[0]} alone; truncated {prefix}_1.npz skipped for {prefix}_0.npz; one "
          f"{size_mb:.0f} MB file: save {save_s:.2f} s, verify+load "
          f"{load_s:.2f} s; resumed run {resumed_s:.2f} s")
    return launches[fused_adam.kernel.symbol]


def optimizer_steps(alexnet_shapes, bw, device: str = "cuda"):
    """Phase 8: each optimizer's 3 steps on `device` against the CPU, from
    one seeded state (AlexNet's leaves and one all-zero leaf) and the same
    gradients; then the clip. Returns each optimizer's numbers."""
    shapes = list(alexnet_shapes) + [(4096,)]
    n_params = sum(math.prod(s) for s in shapes)
    gen = torch.Generator().manual_seed(3)
    init = [torch.randn(s, generator=gen) * 0.02 for s in shapes]
    init[-1].zero_()
    grads = [[torch.randn(s, generator=gen) * 1e-2 for s in shapes] for _ in range(STEPS)]
    out = {}
    for name in OPTIMIZERS:
        lr = OPT_LR[name]
        sides = {}
        for dev in ("cpu", device):
            params = [torch.nn.Parameter(p.to(dev, copy=True)) for p in init]
            opt = cfg_lib.optimizer_from(dict(optimizer=name, learning_rate=lr, **OPT_HP), params)
            ratios, first_zero = [], None
            for t in range(STEPS):
                for p, g in zip(params, grads[t]):
                    p.grad = g.to(dev)
                opt.step()
                if name in TRUST:
                    ratios.append(opt.trust_ratios.cpu())
                if t == 0:
                    first_zero = params[-1].detach().cpu().clone()
            sides[dev] = ([p.detach().cpu() for p in params], ratios, first_zero, opt, params)
        (cpu_p, cpu_r, cpu_z, _, _), (dev_p, dev_r, dev_z, opt, params) = sides["cpu"], sides[device]
        dp = max(float((a - b).abs().max()) for a, b in zip(cpu_p, dev_p))
        rel = max((float(((a - b).abs() / a.abs()).max()) for a, b in zip(cpu_r, dev_r)), default=0.0)
        checks = {"params within 1e-5": dp <= P_TOL, "all on the card": all(
            t.device.type == torch.device(device).type for st in opt.state.values()
            for t in st.values() if torch.is_tensor(t))}
        if name in TRUST:
            checks["trust ratios within 1e-6 relative"] = rel <= RATIO_RTOL
            checks["zero leaf: ratio 1 at step 1 (the unscaled step)"] = (
                float(cpu_r[0][-1]) == float(dev_r[0][-1]) == 1.0)
        if name == "lars":
            checks["zero leaf's first step is -lr * g"] = torch.equal(dev_z, -(grads[0][-1] * lr)) \
                and torch.equal(cpu_z, dev_z)
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise SystemExit(f"chip_smoke: {name} on {device} disagrees with the CPU: {failed}; "
                             f"max|dp|={dp:.3g}, trust-ratio rel err={rel:.3g}")
        update_ms, enqueue_ms = time_ms(opt.step) if device == "cuda" else (None, None)
        bound_ms = OPT_BYTES[name] * n_params / bw * 1e3
        out[name] = dict(lr=lr, max_abs_dp=dp, trust_ratio_rel_err=rel if name in TRUST else None,
                         update_ms=update_ms, enqueue_ms=enqueue_ms, bytes_bound_ms=bound_ms)
        timing = (f"; update_ms={update_ms:.4f} enqueue_ms={enqueue_ms:.4f} (bytes bound "
                  f"{bound_ms:.4f} ms, {OPT_BYTES[name]} B/param)") if update_ms is not None else ""
        phase("8 optimizer steps", f"{name} (lr {lr}, weight_decay 5e-4, momentum 0.9), {STEPS} steps "
              f"on AlexNet's {len(alexnet_shapes)} leaves + 1 all-zero leaf ({n_params} params), "
              f"{device} vs cpu: max|dp|={dp:.3g}"
              + (f", trust ratios max rel err {rel:.3g}, zero leaf's first ratio 1 on both" if name in TRUST
                 else "") + timing)
        del sides, params, opt
    # the clip: a gradient of norm ~7,550 to max_norm 1
    gen = torch.Generator().manual_seed(5)
    base = [torch.randn(s, generator=gen) for s in shapes]
    gs, norms, after = {}, {}, {}
    for dev in ("cpu", device):
        params = [torch.nn.Parameter(torch.zeros(s, device=dev)) for s in shapes]
        for p, g in zip(params, base):
            p.grad = g.to(dev, copy=True)
        norms[dev] = float(optim.clip_grad_norm_(params, 1.0))
        after[dev] = float(optim.global_norm([p.grad for p in params]))
        gs[dev] = [p.grad.cpu() for p in params]
    dg = max(float((a - b).abs().max()) for a, b in zip(gs["cpu"], gs[device]))
    norm_rel = abs(norms[device] - norms["cpu"]) / norms["cpu"]
    if not (norms["cpu"] > 1.0 and dg <= P_TOL and abs(after[device] - 1.0) <= P_TOL
            and norm_rel <= RATIO_RTOL):
        raise SystemExit(f"chip_smoke: clip_grad_norm_ on {device} disagrees: norms {norms}, "
                         f"max|dg|={dg:.3g}, norms after {after}")
    clip_ms = None
    if device == "cuda":
        clip_ms, _ = time_ms(partial(optim.clip_grad_norm_, params, 1.0))
    out["clip"] = dict(norm=norms[device], norm_rel_err=norm_rel, max_abs_dg=dg,
                       norm_after=after[device], ms=clip_ms)
    phase("8 optimizer steps", f"clip_grad_norm_ to 1.0 of a gradient of norm {norms[device]:.2f} "
          f"({device}) vs {norms['cpu']:.2f} (cpu), rel err {norm_rel:.3g}: max|dg|={dg:.3g}, norm "
          f"after {after[device]:.6f}" + (f"; {clip_ms:.4f} ms" if clip_ms is not None else ""))
    return out


def optimizer_epoch(name: str, steady_f32: float):
    """Phase 8: three native AlexNet float32 epochs with `name` (lars and
    lamb with clip 1.0): finite losses, no Adam-kernel launch; epoch 3's
    replayed step beside Adam's."""
    overrides = dict(optimizer=name, **OPT_HP)
    if name in TRUST:
        overrides["clip_grad_norm"] = 1.0
    history, wall_s, launches = native_run(SETTINGS, dict(overrides, num_epochs=3))
    row = history[-1]
    steps = sum(len(r["step_ms"]) for r in history)
    checks = {
        "16 train steps an epoch": all(len(r["step_ms"]) == 16 for r in history),
        "no Adam-kernel launch": sum(launches.values()) == 0,
        "finite losses": all(math.isfinite(r[k]) for r in history for k in ("train_loss", "test_loss")),
        "2048 train / 512 test samples": all(
            (r["train_samples"], r["test_samples"]) == (2048, 512) for r in history),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: native {name} epochs failed {failed}: launches={launches}, "
                         f"history={history}")
    steady = statistics.median(row["step_ms"])
    phase(f"8 native {name}", f"AlexNet@224 b128 float32, {overrides}, 3 epochs at scan_steps auto: "
          f"{steps} steps, Adam-kernel launches {launches}, epoch 3 train_loss={row['train_loss']:.4f} "
          f"test_loss={row['test_loss']:.4f}; step_ms epoch 3 (replayed) {steady:.2f} vs Adam float32 "
          f"{steady_f32:.2f} (ratio {steady / steady_f32:.3f}); wall {wall_s:.2f} s")
    return sum(launches.values()), steady


def _fused_settings(path: str = None, **overrides):
    """The training block of ``managed_fused_h100.yaml`` (or of `path`) as
    written, real digits included, with `overrides`."""
    settings = cfg_lib.load_settings(path or SETTINGS_FUSED)
    cfg_lib.check_settings(settings)
    training = cfg_lib.training_config(settings)
    training.update(overrides)
    return settings, training


def _pair_state(model, opt):
    """Parameters, buffers, optimizer state and the comm hook's residual,
    cloned."""
    state = {f"model/{k}": v.detach().clone() for k, v in model._module.state_dict().items()}
    for i, st in enumerate(opt.optimizer.state.values()):
        state.update({f"opt{i}/{k}": t.clone() for k, t in st.items() if torch.is_tensor(t)})
    for i, r in enumerate(opt.comm_residual() or ()):  # the comm hook's, with the state
        state[f"opt/residual{i}"] = r.clone()
    return state


def graph_vs_eager(label: str, make, steps, depth: int, opt_name: str = "adam", flushes: int = 3,
                   signatures: int = 1, tag: str = "9 graph vs eager"):
    """Phase 9: from one state, the steps of `steps` (``(x, y, w,
    criterion)`` each; ``flushes`` flushes of `depth`, over `signatures`
    flush signatures taking turns) through graph replay and through the
    eager queue (``_graph_replay = False``): max |dp| over parameters,
    buffers and optimizer state, the losses, each kernel's launches as the
    kernel counted them, and the graph counts of the replay run.
    `opt_name`: adam, adam_bf16 (bf16 moments) or lamb."""
    out = {}
    for mode in ("eager", "replay"):
        acc, module, name = make()
        if opt_name == "lamb":
            opt = optim.LAMB(module.parameters(), lr=1e-3, weight_decay=5e-4)
        elif opt_name == "adam_bf16":
            leaf = jax_leaf_index(name, module)
            opt = Adam(module.parameters(), lr=1e-3, state_dtype=torch.bfloat16,
                       leaf_index=[leaf[n] for n, _ in module.named_parameters()])
        else:
            opt = Adam(module.parameters(), lr=1e-3)
        model, opt = acc.prepare(module, opt)
        opt._graph_replay = mode == "replay"
        torch.cuda.manual_seed(7)  # dropout: the same stream in both runs
        reset_counts()
        graphs.reset_stats()
        losses = []
        for x, y, w, criterion in steps[: depth * flushes]:
            opt.zero_grad()
            loss = criterion(model(x), y, w)
            acc.backward(loss)
            opt.step()
            losses.append(loss)
        values = [l.item() for l in losses]
        torch.cuda.synchronize()
        out[mode] = (_pair_state(model, opt), values,
                     {k.symbol: k.launches for k in fused_adam.kernels.values()},
                     dict(graphs.stats), opt.updates)
        del acc, module, model, opt, losses
        torch.cuda.empty_cache()
    (eager, l_e, n_e, _, u_e), (replay, l_r, n_r, g_r, u_r) = out["eager"], out["replay"]
    diff = {k: float((eager[k].double() - replay[k].double()).abs().max()) for k in eager}
    dp = max(v for k, v in diff.items() if k.startswith("model/"))
    dopt = max((v for k, v in diff.items() if k.startswith("opt")), default=0.0)
    dl = max(abs(a - b) for a, b in zip(l_e, l_r))
    n_steps = depth * flushes
    want = {k.symbol: 0 for k in fused_adam.kernels.values()}
    if opt_name != "lamb":
        want[fused_adam.kernels[torch.bfloat16 if opt_name == "adam_bf16" else torch.float32].symbol] = n_steps
    captures, replays = signatures, flushes - signatures
    checks = {
        f"{n_steps} updates each": u_e == u_r == n_steps,
        "1 launch of the moments' kernel per update, counted on the card": n_e == n_r == want,
        f"{captures} captures, {replays} replays": (g_r["captures"], g_r["replays"]) == (captures, replays),
        f"params, buffers and optimizer state within {PATHS_TOL}": max(dp, dopt) <= PATHS_TOL,
        "finite losses": all(math.isfinite(v) for v in l_r),
    }
    failed = [k for k, ok in checks.items() if not ok]
    bitwise = dp == dopt == dl == 0.0
    detail = (f"max|dp|={dp:.3g} max|d opt state|={dopt:.3g} max|d loss|={dl:.3g} "
              f"({'bitwise' if bitwise else 'NOT bitwise'}); launches replay={n_r} eager={n_e}; "
              f"captures={g_r['captures']} replays={g_r['replays']} capture_s={g_r['capture_s']:.3f}")
    if failed:
        raise SystemExit(f"chip_smoke: graph replay vs eager queue, {label}, failed {failed}: {detail}")
    phase(tag, f"{label}, depth {depth}, {flushes} flushes ({n_steps} steps) from one "
          f"state: {detail}; losses (replay) first {l_r[0]:.6f} last {l_r[-1]:.6f}")
    return dict(label=label, depth=depth, steps=n_steps, max_abs_dp=dp, max_abs_d_opt_state=dopt,
                max_abs_d_loss=dl, bitwise=bitwise, launches_replay=n_r, launches_eager=n_e,
                capture_s=g_r["capture_s"])


def digits_batches(n: int, batch: int = 32, seed: int = 0):
    """`n` batches of `batch` real digits rows, drawn with a seeded numpy
    generator."""
    train, _ = load_datasets_for({"dataset": "digits"})
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        idx = rng.integers(0, len(train), batch)
        out.append((train.images[idx], train.labels[idx].astype(np.int64), np.ones(batch, np.float32)))
    return out


def graph_pairs():
    """Phase 9: graph replay against the eager queue on toy_cnn/digits at
    depth 32 (Adam with float32 and with bf16 moments, LAMB, and two flush
    signatures of one length taking turns: 32 rows under the mean
    criterion, 20 under the sum criterion) and on AlexNet@224 b128 at depth
    8 with flips and dropout."""
    mean = CrossEntropyLoss()  # one object: a new criterion flushes the queue
    digits = [b + (mean,) for b in digits_batches(96)]
    total = CrossEntropyLoss(reduction="sum")
    ragged = [b + (mean,) for b in digits_batches(32, seed=1)]
    ragged += [b + (total,) for b in digits_batches(32, batch=20, seed=2)]
    # flushes of 32: mean, sum, mean, sum, mean, sum
    turns = [ragged[32 * (i % 2) + j] for i in range(6) for j in range(32)]
    _, training = _fused_settings()
    norm = norm_stats_for(training)

    def toy():
        acc = Accelerator(seed=0, fuse_steps=32, device="cuda")
        acc.augment = make_train_augment(size=None, flip=False, mean=norm[0], std=norm[1],
                                         generator=acc.generator)
        torch.manual_seed(0)
        return acc, load_model("toy_cnn", 10, input_shape=(8, 8, 3)), "toy_cnn"

    gen = torch.Generator().manual_seed(1)
    alex_batches = [(torch.randint(0, 256, (128, 32, 32, 3), dtype=torch.uint8, generator=gen).numpy(),
                     torch.randint(0, 10, (128,), generator=gen).numpy(), np.ones(128, np.float32), mean)
                    for _ in range(24)]

    def alex():
        acc = Accelerator(seed=0, fuse_steps=8, device="cuda")
        acc.augment = make_train_augment(size=224, flip=True, generator=acc.generator)
        torch.manual_seed(0)
        return acc, AlexNet(num_classes=10), "alexnet"

    return [
        graph_vs_eager("toy_cnn digits b32 adam", toy, digits, 32),
        graph_vs_eager("toy_cnn digits b32 adam bf16 moments", toy, digits, 32, "adam_bf16"),
        graph_vs_eager("toy_cnn digits b32 lamb", toy, digits, 32, "lamb"),
        graph_vs_eager("toy_cnn digits b32 mean / b20 sum in turns adam", toy, turns, 32, flushes=6,
                       signatures=2),
        graph_vs_eager("AlexNet@224 b128 flip dropout adam", alex, alex_batches, 8),
    ]


FUSED_TURNS = ("replay", "eager", "depth 1", "depth 1", "eager", "replay")


def fused_run(mode: str, save_dir=None, **overrides):
    """``managed_fused_h100.yaml`` as written (6 epochs of real digits)
    through ``train_accelerate``'s worker, with graph replay, the eager
    queue or ``fuse_steps: 1``; counts set to 0 just before it and read just
    after: ``(history, Adam launches, graph counts, wall s)``."""
    settings, training = _fused_settings(**overrides)
    if mode == "depth 1":
        training["fuse_steps"] = 1
    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
    reset_counts()
    graphs.reset_stats()
    PreparedOptimizer._graph_replay = mode != "eager"
    t0 = time.perf_counter()
    try:
        history = run_ddp_training(
            partial(basic_accelerate_training, training=training, device="cuda"),
            1, save_dir, cfg_lib.optional_args_from(settings), backend="cuda",
        )
        torch.cuda.synchronize()
    finally:
        PreparedOptimizer._graph_replay = True
    return (history, sum(k.launches for k in fused_adam.kernels.values()), dict(graphs.stats),
            time.perf_counter() - t0)


def fused_turns(root: str):
    """Phase 9: the fused configuration as written, in turns with the eager
    queue and depth 1: finite losses, the accuracy, 1 launch per update,
    two graphs (32 and 13 steps) replayed every epoch after the first; step
    medians over epochs 2-6."""
    medians = {m: [] for m in FUSED_TURNS}
    launches = {m: 0 for m in FUSED_TURNS}
    runs = {}
    for i, mode in enumerate(FUSED_TURNS):
        save_dir = os.path.join(root, f"turn{i}")
        history, n, g, wall = fused_run(mode, save_dir)
        steps = [ms for row in history[1:] for ms in row["step_ms"]]
        medians[mode].append(statistics.median(steps))
        launches[mode] += n
        runs.setdefault(mode, (history, n, g, wall))
        updates = sum(r["updates"] for r in history)
        checks = {
            "6 epochs of 45 steps": [len(r["step_ms"]) for r in history] == [45] * 6,
            "1 Adam-kernel launch per update": n == updates == 270,
            "finite losses": all(math.isfinite(r[k]) for r in history for k in ("train_loss", "test_loss")),
            "1437 train / 360 test rows": all(
                (r["train_samples"], r["test_samples"]) == (1437, 360) for r in history),
            "the history row's depth": all(r["fuse_steps"] == (1 if mode == "depth 1" else 32) for r in history),
            "state_0 and state_5 written": sorted(f for f in os.listdir(save_dir) if f.endswith(".npz")) == [
                "model.npz", "state_0.npz", "state_5.npz"],
        }
        fused = g["by_kind"].get("fused", {"captures": 0, "replays": 0})
        if mode == "replay":
            checks["2 captures, 10 replays"] = (fused["captures"], fused["replays"]) == (2, 10)
        else:
            checks["no graph"] = fused["replays"] == 0
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise SystemExit(f"chip_smoke: managed_fused_h100.yaml ({mode}) failed {failed}: "
                             f"launches={n}, graphs={g}, history={history}")
        shutil.rmtree(save_dir)
    rows = {m: [(r["train_loss"], r["test_loss"], r["test_accuracy"]) for r in runs[m][0]] for m in runs}
    same = {m: rows[m] == rows["replay"] for m in rows}
    last = runs["replay"][0][-1]
    g = runs["replay"][2]["by_kind"]["fused"]
    fmt = lambda xs: ", ".join(f"{x:.4f}" for x in xs)
    phase("9 managed fused", f"managed_fused_h100.yaml as written (toy_cnn, real digits, b32, 6 epochs, "
          f"fuse_steps auto = 32): train_loss {fmt([r['train_loss'] for r in runs['replay'][0]])}; "
          f"epoch 6 test_loss={last['test_loss']:.4f} test_accuracy={last['test_accuracy']:.2f}%; "
          f"{runs['replay'][1]} fused_adam launches for 270 updates; captures={g['captures']} "
          f"replays={g['replays']} capture_s={g['capture_s']:.3f}; epoch rows equal to the replay "
          f"run's: {same}; turns {'/'.join(FUSED_TURNS)}: step median (epochs 2-6) ms "
          + "; ".join(f"{m} [{fmt(v)}]" for m, v in medians.items())
          + f"; wall s " + ", ".join(f"{m} {runs[m][3]:.2f}" for m in runs))
    return dict(medians=medians, launches=launches, rows_equal=same, capture_s=g["capture_s"],
                captures=g["captures"], replays=g["replays"], test_accuracy=last["test_accuracy"])


def fused_alexnet(steady_managed: float):
    """Phase 9: two managed AlexNet@224 b128 epochs (synthetic stand-in) at
    ``fuse_steps: 8`` with graph replay (4 flushes: warm-up, capture, 2
    replays), through the eager queue and at ``fuse_steps: 1``, in turns
    (``FUSED_TURNS``): one launch per update, counted on the card; each
    run's epoch-2 step median, and the mean of epoch 2's steps 9-16 (at
    depth 8 one flush, which shares no epoch start), beside the unfused
    managed median of phase 5."""
    settings, training = training_for(SETTINGS_MANAGED)
    medians = {m: [] for m in FUSED_TURNS}
    late = {m: [] for m in FUSED_TURNS}  # mean of epoch 2's steps 9-16
    launches = {m: 0 for m in FUSED_TURNS}
    capture_s = []
    for mode in FUSED_TURNS:
        depth = 1 if mode == "depth 1" else 8
        reset_counts()
        graphs.reset_stats()
        PreparedOptimizer._graph_replay = mode != "eager"
        try:
            history = run_ddp_training(
                partial(basic_accelerate_training, training=dict(training, fuse_steps=depth, num_epochs=2),
                        device="cuda"),
                1, None, cfg_lib.optional_args_from(settings), backend="cuda",
            )
            torch.cuda.synchronize()
        finally:
            PreparedOptimizer._graph_replay = True
        n = fused_adam.kernel.launches
        g = graphs.stats["by_kind"].get("fused", {"captures": 0, "replays": 0})
        checks = {
            "2 epochs of 16 steps": [len(r["step_ms"]) for r in history] == [16, 16],
            "32 updates, 1 launch each": n == sum(r["updates"] for r in history) == 32,
            "finite losses": all(math.isfinite(r[k]) for r in history for k in ("train_loss", "test_loss")),
            f"depth {depth} in the rows": all(r["fuse_steps"] == depth for r in history),
        }
        if mode == "replay":
            checks["1 capture, 3 replays"] = (g["captures"], g["replays"]) == (1, 3)
            capture_s.append(g["capture_s"])
        else:
            checks["no graph"] = g["replays"] == 0
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise SystemExit(f"chip_smoke: managed AlexNet at depth {depth} ({mode}) failed {failed}: "
                             f"launches={n}, graphs={g}, history={history}")
        medians[mode].append(statistics.median(history[1]["step_ms"]))
        late[mode].append(statistics.fmean(history[1]["step_ms"][8:]))
        launches[mode] += n
    fmt = lambda xs: ", ".join(f"{x:.3f}" for x in xs)
    ratio = lambda d, m: f"{min(d[m]) / min(d['depth 1']):.3f}"
    phase("9 managed fused AlexNet", f"AlexNet@224 b128 float32 managed, 2 epochs each, turns "
          f"{'/'.join(FUSED_TURNS)} (depth 8 but depth 1): {launches} fused_adam launches; capture_s "
          f"{fmt(capture_s)}; epoch-2 step median ms " + "; ".join(f"{m} [{fmt(v)}]" for m, v in medians.items())
          + f" (replay/depth 1 {ratio(medians, 'replay')}, eager/depth 1 {ratio(medians, 'eager')}, least "
          f"of each); epoch-2 steps 9-16 mean ms " + "; ".join(f"{m} [{fmt(v)}]" for m, v in late.items())
          + f" (replay/depth 1 {ratio(late, 'replay')}, eager/depth 1 {ratio(late, 'eager')}); phase 5's "
          f"unfused managed median {steady_managed:.2f}")
    return launches, dict(medians=medians, steps_9_16_mean=late), capture_s


def fused_resume(root: str):
    """Phase 9: the fused configuration for 5 epochs, then resumed for the
    6th, against 6 straight epochs (``checkpoint_epoch: 1``): epoch 6 equal,
    ``state_5.npz`` equal at max |dp| = 0, 45 launches in the resumed run."""
    straight, resumed = os.path.join(root, "straight"), os.path.join(root, "resumed")
    whole, _, _, _ = fused_run("replay", straight, checkpoint_epoch=1)
    fused_run("replay", resumed, checkpoint_epoch=1, num_epochs=5)
    again, launches, g, _ = fused_run("replay", resumed, checkpoint_epoch=1, resume=True)
    a, b = _arrays(os.path.join(straight, "state_5.npz")), _arrays(os.path.join(resumed, "state_5.npz"))
    dp = max(float(np.abs(a[k].astype(np.float64) - b[k].astype(np.float64)).max())
             for k in a if a[k].dtype.kind == "f")
    checks = {
        "epoch 6 resumed alone": [r["epoch"] for r in again] == [5],
        "epoch 6's losses and accuracy equal": [(again[0][k]) for k in ("train_loss", "test_loss", "test_accuracy")]
        == [whole[5][k] for k in ("train_loss", "test_loss", "test_accuracy")],
        "max |dp| = 0": dp == 0.0,
        "every array equal": sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a),
        "45 launches in the resumed run": launches == 45,
    }
    shutil.rmtree(straight)
    shutil.rmtree(resumed)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: fused resume failed {failed}: max|dp|={dp}, straight={whole[5]}, "
                         f"resumed={again}")
    phase("9 fused resume", f"managed_fused_h100.yaml, 5 epochs then resumed for the 6th against 6 straight: "
          f"epoch 6 train_loss={again[0]['train_loss']:.4f} test_loss={again[0]['test_loss']:.4f} equal, "
          f"state_5.npz max|dp|=0, {launches} fused_adam launches, graphs {g}")
    return launches


def digits_native():
    """Phase 8: ``digits_h100.yaml`` as written (toy_cnn with sync_bn, real
    digits, 10 epochs) through the native worker: finite losses, one launch
    per step, the accuracy."""
    settings, training = _fused_settings(SETTINGS_DIGITS)
    reset_counts()
    t0 = time.perf_counter()
    history = run_ddp_training(
        partial(basic_ddp_training_loop, training=training, device="cuda"),
        1, None, cfg_lib.optional_args_from(settings), backend="cuda",
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = sum(len(r["step_ms"]) for r in history)
    last = history[-1]
    checks = {
        "10 epochs of 45 steps": [len(r["step_ms"]) for r in history] == [45] * 10,
        "1 launch per step": fused_adam.kernel.launches == steps,
        "finite losses": all(math.isfinite(r[k]) for r in history for k in ("train_loss", "test_loss")),
        "1437 train / 360 test rows": (last["train_samples"], last["test_samples"]) == (1437, 360),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: digits_h100.yaml failed {failed}: history={history}")
    phase("8 digits", f"digits_h100.yaml as written (toy_cnn sync_bn, real digits, b32, 10 epochs, native): "
          f"{fused_adam.kernel.launches} fused_adam launches; train_loss {history[0]['train_loss']:.4f} -> "
          f"{last['train_loss']:.4f}, test_loss={last['test_loss']:.4f}, test_accuracy="
          f"{last['test_accuracy']:.2f}%; step median {statistics.median(last['step_ms']):.2f} ms; "
          f"wall {wall:.2f} s")
    return fused_adam.kernel.launches


# ---------------------------------------------------------------- phase 10 --

NATIVE_TURNS = ("replay", "eager", "depth 1", "depth 1", "eager", "replay")
ALEXNET_TURNS = ("auto", "depth 1", "depth 1", "auto")


def _kinds(g: dict) -> dict:
    """Captures and replays by caller kind."""
    return {k: (v["captures"], v["replays"]) for k, v in g["by_kind"].items()}


def native_chunk_pair(label: str, make, batches, k: int, opt_name: str = "adam", accum: int = 1,
                      chunks: int = 3, zero1: bool = False, tag: str = "10 native graph vs eager",
                      comm_hook: str = "none", tables: int = 1):
    """Phase 10: `chunks` chunks of `k` batches through
    ``DistributedDataParallel.train_step_many`` from one state, as graph
    replays and eagerly (``_graph_replay = False``): max |dp| over
    parameters, buffers and optimizer state (the comm hook's residual
    with it), the sums, each kernel's launches as the kernel counted them,
    the graph counts and the seconds of each run."""
    out = {}
    for mode in ("eager", "replay"):
        model, augment, gen, name = make()
        if opt_name == "lars":
            opt = optim.LARS(model.parameters(), lr=0.1, **OPT_HP)
        elif opt_name == "adam_bf16":
            leaf = jax_leaf_index(name, model)
            opt = Adam(model.parameters(), lr=1e-3, state_dtype=torch.bfloat16,
                       leaf_index=[leaf[n] for n, _ in model.named_parameters()])
        else:
            opt = Adam(model.parameters(), lr=1e-3)
        ddp = DistributedDataParallel(model, opt, CrossEntropyLoss(), augment=augment, device="cuda",
                                      grad_accumulation=accum, generator=gen,
                                      weight_update_sharding=zero1, comm_hook=comm_hook)
        ddp._graph_replay = mode == "replay"
        torch.cuda.manual_seed(7)  # dropout: the same stream in both runs
        reset_counts()
        graphs.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sums = None
        for c in range(chunks):
            sums = ddp.train_step_many(batches[c * k:(c + 1) * k], sums)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        state = {f"model/{n}": t.detach().clone() for n, t in model.state_dict().items()}
        for i, st in enumerate(opt.state.values()):
            state.update({f"opt{i}/{n}": t.clone() for n, t in st.items() if torch.is_tensor(t)})
        if ddp.residual is not None:
            state["opt/residual"] = ddp.residual.clone()
        rows = set().union(*(kn.table_rows for kn in fused_adam.kernels.values()))
        out[mode] = (state, sums.clone(), {kn.symbol: kn.launches for kn in fused_adam.kernels.values()},
                     dict(graphs.stats), ddp.step, seconds, rows)
        del ddp, model, opt, state
        torch.cuda.empty_cache()
    (eager, s_e, n_e, _, step_e, sec_e, rows_e), (replay, s_r, n_r, g, step_r, sec_r, rows_r) = (
        out["eager"], out["replay"])
    diff = {key: float((eager[key].double() - replay[key].double()).abs().max()) for key in eager}
    dp = max(v for key, v in diff.items() if key.startswith("model/"))
    dopt = max((v for key, v in diff.items() if key.startswith("opt")), default=0.0)
    dsum = float((s_e.double() - s_r.double()).abs().max())
    updates = chunks * k // accum
    want = {kn.symbol: 0 for kn in fused_adam.kernels.values()}
    if opt_name != "lars":
        want[fused_adam.kernels[torch.bfloat16 if opt_name == "adam_bf16" else torch.float32].symbol] = (
            updates * tables)
    checks = {
        f"params, buffers, optimizer state and sums within {PATHS_TOL}": max(dp, dopt, dsum) <= PATHS_TOL,
        f"{tables} launch(es) of the moments' kernel per update, counted on the card": n_e == n_r == want,
        f"1 capture, {chunks - 1} replays": _kinds(g) == {"train": (1, chunks - 1)},
        f"step {chunks * k}": step_e == step_r == chunks * k,
        "finite sums": bool(torch.isfinite(s_r).all()),
    }
    if zero1 and opt_name != "lars":
        checks["each launch a table of one row (the flat shard)"] = rows_e == rows_r == {1}
    bitwise = dp == dopt == dsum == 0.0
    detail = (f"max|dp|={dp:.3g} max|d opt state|={dopt:.3g} max|d sums|={dsum:.3g} "
              f"({'bitwise' if bitwise else 'NOT bitwise'}); launches replay={n_r} eager={n_e}; "
              f"captures/replays {_kinds(g)}, capture_s={g['capture_s']:.3f}; run s replay "
              f"{sec_r:.3f} eager {sec_e:.3f}")
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: native chunk replay vs eager, {label}, failed {failed}: {detail}")
    phase(tag, f"{label}, K={k}, A={accum}, {chunks} chunks ({updates} updates) "
          f"from one state: {detail}")
    return dict(label=label, k=k, accum=accum, updates=updates, max_abs_dp=dp, max_abs_d_opt_state=dopt,
                max_abs_d_sums=dsum, bitwise=bitwise, launches_replay=n_r, launches_eager=n_e,
                capture_s=g["capture_s"])


def native_eval_pair(label: str, model_fn, transform, batches, k: int, groups: int = 3):
    """Phase 10: `groups` eval groups of `k` batches through
    ``eval_step_many``, replayed and eagerly: the sums, bitwise."""
    out = {}
    for mode in ("eager", "replay"):
        model = model_fn()
        ddp = DistributedDataParallel(model, Adam(model.parameters()), CrossEntropyLoss(),
                                      eval_transform=transform, device="cuda")
        ddp._graph_replay = mode == "replay"
        graphs.reset_stats()
        sums = None
        for c in range(groups):
            sums = ddp.eval_step_many(batches[c * k:(c + 1) * k], sums)
        out[mode] = (sums.clone(), dict(graphs.stats))
    (s_e, _), (s_r, g) = out["eager"], out["replay"]
    dsum = float((s_e.double() - s_r.double()).abs().max())
    if not (dsum <= PATHS_TOL and _kinds(g) == {"eval": (1, groups - 1)}):
        raise SystemExit(f"chip_smoke: eval group replay vs eager, {label}: max|d sums|={dsum}, graphs {g}")
    phase("10 native graph vs eager", f"{label}, {groups} eval groups of {k}: max|d sums|={dsum:.3g} "
          f"({'bitwise' if dsum == 0 else 'NOT bitwise'}); captures/replays {_kinds(g)}; sums "
          f"{[round(v, 4) for v in s_r.tolist()]}")
    return dict(label=label, k=k, max_abs_d_sums=dsum, bitwise=dsum == 0.0)


def native_pairs():
    """Phase 10: native chunk replay against its eager chunk: toy_cnn with
    sync_bn on real digits at K = 45 (Adam, bf16-moment Adam, LARS), the
    digits eval groups at K = 8, AlexNet@224 b128 at K = 8 with flips and
    dropout, and at A = 2."""
    _, training = _fused_settings(SETTINGS_DIGITS)
    mean, std = norm_stats_for(training)
    digits = digits_batches(135)

    def toy():
        torch.manual_seed(0)
        gen = torch.Generator().manual_seed(1)
        model = convert_sync_batchnorm(load_model("toy_cnn", 10, input_shape=(8, 8, 3)))
        return (model, make_train_augment(size=None, flip=False, mean=mean, std=std, generator=gen),
                gen, "toy_cnn")

    gen = torch.Generator().manual_seed(1)
    alex_batches = [(torch.randint(0, 256, (128, 32, 32, 3), dtype=torch.uint8, generator=gen).numpy(),
                     torch.randint(0, 10, (128,), generator=gen).numpy(), np.ones(128, np.float32))
                    for _ in range(24)]

    def alex():
        torch.manual_seed(0)
        g = torch.Generator().manual_seed(1)
        return AlexNet(num_classes=10), make_train_augment(size=224, flip=True, generator=g), g, "alexnet"

    def toy_eval():
        torch.manual_seed(0)
        return convert_sync_batchnorm(load_model("toy_cnn", 10, input_shape=(8, 8, 3)))

    _, test = load_datasets_for({"dataset": "digits"})
    rng = np.random.default_rng(4)
    eval_batches = []
    for _ in range(24):
        idx = rng.integers(0, len(test), 45)
        eval_batches.append((test.images[idx], test.labels[idx].astype(np.int64),
                             (rng.random(45) < 0.9).astype(np.float32)))
    pairs = [
        native_chunk_pair("toy_cnn sync_bn digits b32 adam", toy, digits, 45),
        native_chunk_pair("toy_cnn sync_bn digits b32 adam bf16 moments", toy, digits, 45, "adam_bf16"),
        native_chunk_pair("toy_cnn sync_bn digits b32 lars", toy, digits, 45, "lars"),
        native_chunk_pair("AlexNet@224 b128 flip dropout adam", alex, alex_batches, 8),
        native_chunk_pair("AlexNet@224 b128 flip dropout adam, A=2", alex, alex_batches, 8, accum=2),
    ]
    evals = [native_eval_pair("toy_cnn sync_bn digits b45", toy_eval,
                              make_eval_transform(size=None, mean=mean, std=std), eval_batches, 8)]
    return pairs, evals


def _native_turn_run(training, mode: str, settings):
    """The native worker on `training` with graph replay, eagerly
    (``_graph_replay = False``) or at ``scan_steps: 1``; counts set to 0
    just before it and read just after: ``(history, launches, graph counts,
    wall s)``."""
    if mode == "depth 1":
        training = dict(training, scan_steps=1)
    reset_counts()
    graphs.reset_stats()
    DistributedDataParallel._graph_replay = mode != "eager"
    t0 = time.perf_counter()
    try:
        history = run_ddp_training(partial(basic_ddp_training_loop, training=training, device="cuda"),
                                   1, None, cfg_lib.optional_args_from(settings), backend="cuda")
        torch.cuda.synchronize()
    finally:
        DistributedDataParallel._graph_replay = True
    return (history, sum(k.launches for k in fused_adam.kernels.values()), dict(graphs.stats),
            time.perf_counter() - t0)


def native_digits_turns():
    """Phase 10: ``digits_h100.yaml`` as written (10 epochs, ``scan_steps:
    auto`` = 45 train and 8 eval batches per dispatch) with graph replay,
    eagerly and at ``scan_steps: 1``, in turns: the accuracy, equal epoch
    rows, 450 launches, the captures and replays of train and eval, and
    each run's step median over epochs 3-10."""
    settings, training = _fused_settings(SETTINGS_DIGITS)
    medians = {m: [] for m in NATIVE_TURNS}
    launches = {m: 0 for m in NATIVE_TURNS}
    walls = {m: [] for m in NATIVE_TURNS}
    runs = {}
    for mode in NATIVE_TURNS:
        history, n, g, wall = _native_turn_run(training, mode, settings)
        medians[mode].append(statistics.median([ms for r in history[2:] for ms in r["step_ms"]]))
        launches[mode] += n
        walls[mode].append(wall)
        runs.setdefault(mode, (history, g))
        k = 1 if mode == "depth 1" else 45
        checks = {
            "10 epochs of 45 steps": [len(r["step_ms"]) for r in history] == [45] * 10,
            "450 launches, counted on the card": n == 450,
            "finite losses": all(math.isfinite(r[key]) for r in history for key in ("train_loss", "test_loss")),
            "1437 train / 360 test rows": all(
                (r["train_samples"], r["test_samples"]) == (1437, 360) for r in history),
            f"scan_steps {k} / eval {8 if k > 1 else 1} in the rows": all(
                (r["scan_steps"], r["eval_scan_steps"]) == (k, 8 if k > 1 else 1) for r in history),
            "graphs": _kinds(g) == ({"train": (1, 9), "eval": (1, 9)} if mode == "replay" else {}),
        }
        failed = [c for c, ok in checks.items() if not ok]
        if failed:
            raise SystemExit(f"chip_smoke: native digits ({mode}) failed {failed}: launches={n}, "
                             f"graphs={g}, history={history}")
    rows = {m: [(r["train_loss"], r["test_loss"], r["test_accuracy"]) for r in runs[m][0]] for m in runs}
    same = {m: rows[m] == rows["replay"] for m in rows}
    if not all(same.values()):
        raise SystemExit(f"chip_smoke: native digits epoch rows differ between modes: {rows}")
    last = runs["replay"][0][-1]
    g = runs["replay"][1]
    fmt = lambda xs: ", ".join(f"{x:.3f}" for x in xs)
    phase("10 native digits", f"digits_h100.yaml as written (toy_cnn sync_bn, real digits, b32, 10 epochs, "
          f"scan_steps auto = 45 train / 8 eval): epoch 10 train_loss={last['train_loss']:.4f} test_loss="
          f"{last['test_loss']:.4f} test_accuracy={last['test_accuracy']:.2f}%; epoch rows equal: {same}; "
          f"launches {launches}; captures/replays {_kinds(g)}, capture_s={g['capture_s']:.3f}; turns "
          f"{'/'.join(NATIVE_TURNS)} (launches: both runs of each mode): step median (epochs 3-10) ms "
          + "; ".join(f"{m} [{fmt(v)}]" for m, v in medians.items())
          + "; wall s " + "; ".join(f"{m} [{fmt(v)}]" for m, v in walls.items()))
    return dict(medians=medians, launches=launches, rows_equal=same, capture_s=g["capture_s"],
                graphs=_kinds(g), test_accuracy=last["test_accuracy"], wall_s=walls)


def native_alexnet_turns():
    """Phase 10: 3 epochs of ``cifar10_alexnet_h100.yaml`` (the synthetic
    stand-in: 16 train and 6 eval batches, ``scan_steps: auto`` = 16 and 6)
    against ``scan_steps: 1``, in turns: equal epoch rows, 48 launches, and
    each run's epoch-3 step median."""
    settings, training = training_for(SETTINGS)
    training["num_epochs"] = 3
    medians = {m: [] for m in ALEXNET_TURNS}
    launches = {m: 0 for m in ALEXNET_TURNS}
    runs = {}
    for mode in ALEXNET_TURNS:
        history, n, g, _ = _native_turn_run(training, "depth 1" if mode == "depth 1" else "replay", settings)
        medians[mode].append(statistics.median(history[2]["step_ms"]))
        launches[mode] += n
        runs.setdefault(mode, (history, g))
        checks = {
            "3 epochs of 16 steps": [len(r["step_ms"]) for r in history] == [16] * 3,
            "48 launches, counted on the card": n == 48,
            "finite losses": all(math.isfinite(r[key]) for r in history for key in ("train_loss", "test_loss")),
            "graphs": _kinds(g) == ({"train": (1, 2), "eval": (1, 2)} if mode == "auto" else {}),
        }
        failed = [c for c, ok in checks.items() if not ok]
        if failed:
            raise SystemExit(f"chip_smoke: native AlexNet ({mode}) failed {failed}: graphs={g}, history={history}")
    rows = {m: [(r["train_loss"], r["test_loss"], r["test_accuracy"]) for r in runs[m][0]] for m in runs}
    same = rows["auto"] == rows["depth 1"]
    if not same:
        raise SystemExit(f"chip_smoke: native AlexNet epoch rows differ between auto and depth 1: {rows}")
    g = runs["auto"][1]
    fmt = lambda xs: ", ".join(f"{x:.3f}" for x in xs)
    phase("10 native AlexNet", f"cifar10_alexnet_h100.yaml, 3 epochs (synthetic stand-in, scan_steps auto = "
          f"16 train / 6 eval) against scan_steps 1, launches of both runs of each: epoch rows equal ({', '.join(f'{a:.4f}/{b:.4f}' for a, b, _ in rows['auto'])}); "
          f"launches {launches}; captures/replays {_kinds(g)}, capture_s={g['capture_s']:.3f}; turns "
          f"{'/'.join(ALEXNET_TURNS)}: epoch-3 step median ms "
          + "; ".join(f"{m} [{fmt(v)}]" for m, v in medians.items())
          + f" (auto/depth 1 {min(medians['auto']) / min(medians['depth 1']):.3f}, least of each)")
    return dict(medians=medians, launches=launches, rows_equal=same, capture_s=g["capture_s"], graphs=_kinds(g))


EVAL_TURNS = ("groups", "depth 1", "depth 1", "groups")


def managed_eval_groups(passes: int = 5):
    """Phase 10: ``managed_fused_h100.yaml``'s model trained two epochs
    (fused steps, replayed in the second), then its evaluator over the digits test
    stream (8 batches of 45) `passes` times, with groups (auto: one group
    of 8, replayed from the third pass) and at ``fuse_steps=1``, in turns:
    every pass's sums bitwise equal across modes, and the ms per eval pass
    over passes 3-`passes`."""
    _, training = _fused_settings()
    ms = {m: [] for m in EVAL_TURNS}
    launches = {m: 0 for m in EVAL_TURNS}
    sums, kinds = {}, {}
    for mode in EVAL_TURNS:
        reset_counts()
        graphs.reset_stats()
        acc, model, opt, train_loader, test_loader, criterion, transform = managed_build(training, "cuda")
        for epoch in range(2):
            train_loader.set_epoch(epoch)
            managed_train(model, train_loader, criterion, opt, acc)
        torch.cuda.synchronize()
        trained = fused_adam.kernel.launches
        launches[mode] += trained
        ev = FusedEvaluator(model, criterion, transform=transform, fuse_steps=1 if mode == "depth 1" else None)
        results, times = [], []
        for _ in range(passes):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for x, y, w in test_loader:
                ev.add(x, y, w)
            results.append(ev.finalize())  # one host read, after the last group
            times.append((time.perf_counter() - t0) * 1e3)
        ms[mode].append(statistics.median(times[2:]))
        sums.setdefault(mode, results)
        kinds[mode] = _kinds(graphs.stats)
        want = {"fused": (2, 2)}
        if mode == "groups":
            want["managed eval"] = (1, passes - 1)  # the capture's own launch counts as a replay
        if not (trained == 90 and len(set(results)) == 1 and kinds[mode] == want):
            raise SystemExit(f"chip_smoke: managed eval groups ({mode}) failed: launches {trained}, "
                             f"pass results {results}, graphs {kinds[mode]} (expected {want})")
        del acc, model, opt, ev
    same = sums["groups"] == sums["depth 1"]
    if not same:
        raise SystemExit(f"chip_smoke: managed eval groups differ from fuse_steps=1: {sums}")
    loss_sum, correct, total = sums["groups"][0]
    fmt = lambda xs: ", ".join(f"{x:.3f}" for x in xs)
    phase("10 managed eval groups", f"managed_fused_h100.yaml's model after 2 fused epochs (90 launches "
          f"each), its evaluator over 360 test rows in 8 batches of 45, {passes} passes: groups (one of 8, "
          f"captured at pass 2) and fuse_steps=1 give the same sums bitwise (loss sum {loss_sum:.6f}, "
          f"{correct}/{total} correct); graphs {kinds['groups']}; turns {'/'.join(EVAL_TURNS)}: ms per "
          f"eval pass (median of passes 3-{passes}) " + "; ".join(f"{m} [{fmt(v)}]" for m, v in ms.items())
          + f" (groups/depth 1 {min(ms['groups']) / min(ms['depth 1']):.3f}, least of each)")
    return dict(ms_per_pass=ms, launches=launches, sums_equal=same, graphs=kinds["groups"])


# ---------------------------------------------------------------- phase 11 --

STEM_TURNS = ("s2d", "alexnet", "alexnet", "s2d")
FLAT_BASE = 28_522_405  # half AlexNet's flat vector: rank 1's base at world 2, managed


def fast_file():
    """Phase 11: the fast file for 3 epochs (one 16-step chunk each: warm-up,
    capture, replay): finite losses, one bf16-kernel launch of one row per
    update, history rows marked ZeRO-1. Returns ``(launches, history)``."""
    bf16 = fused_adam.kernels[torch.bfloat16]
    history, wall_s, launches = native_run(SETTINGS_FAST, {"num_epochs": 3})
    steps = check_epochs("the fast file", history, launches, bf16, False)
    rows = dict(bf16.table_rows)
    checks = {
        "each launch a table of one row (the flat shard)": set(rows) == {1},
        "history rows say weight_update_sharding": all(r["weight_update_sharding"] for r in history),
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: the fast file failed {failed}: tables by rows {rows}")
    last = history[-1]
    phase("11 fast file", f"cifar10_alexnet_fast_h100.yaml (alexnet_s2d, bf16 compute and moments, "
          f"ZeRO-1, scan_steps auto), 3 epochs: {steps} steps, {bf16.symbol} launches="
          f"{launches[bf16.symbol]} ({launches[bf16.symbol] // steps}/step), tables built by rows {rows}; "
          + ", ".join(f"epoch {r['epoch'] + 1} {r['train_loss']:.4f}/{r['test_loss']:.4f}" for r in history)
          + f"; step_ms epoch 3 (replayed) {statistics.median(last['step_ms']):.2f}; wall {wall_s:.2f} s")
    return launches[bf16.symbol], history


def fast_chunk_pair():
    """Phase 11: 3 chunks of 8 of the fast file's steps (alexnet_s2d, bf16
    compute and moments, ZeRO-1, flips and dropout) replayed against the
    same chunks run eagerly, from one state."""
    _, training = training_for(SETTINGS_FAST)
    gen = torch.Generator().manual_seed(2)
    batches = [(torch.randint(0, 256, (128, 32, 32, 3), dtype=torch.uint8, generator=gen).numpy(),
                torch.randint(0, 10, (128,), generator=gen).numpy(), np.ones(128, np.float32))
               for _ in range(24)]
    mean, std = norm_stats_for(training)

    def make():
        torch.manual_seed(0)
        g = torch.Generator().manual_seed(1)
        augment = make_train_augment(size=224, flip=True, mean=mean, std=std, generator=g,
                                     compute_dtype=torch.bfloat16)
        return load_model("alexnet_s2d", 10), augment, g, "alexnet_s2d"

    return native_chunk_pair("the fast file's step (alexnet_s2d, bf16, ZeRO-1), flip dropout",
                             make, batches, 8, "adam_bf16", zero1=True, tag="11 fast file")


def flat_compare(wrapper, n: int):
    """Phase 11: the flat-shard launch (one row of `n` elements, JAX leaf 0)
    against the plain version, 3 steps from the kernel's state, at base 0
    and at FLAT_BASE; bf16 moments also at zero gradients (bitwise).
    Returns max |dp| / max(1, |p|)."""
    bf16 = wrapper.moment_dtype == torch.bfloat16
    runs = [(base, False) for base in (0, FLAT_BASE)]
    if bf16:
        runs += [(base, True) for base in (0, FLAT_BASE)]
    errs = []
    for base, zero_grad in runs:
        kern = make_leaves([(n,)], seed=5, moments=wrapper.moment_dtype, zero_grad=zero_grad)
        dp = dm = dv = 0.0
        outside = apart = 0
        for t in range(1, STEPS + 1):
            before, plain = clone(kern), clone(kern)
            bc1, bc2 = fused_adam.bias_corrections(t, HP["betas"])
            (p, g, m, v), = kern
            wrapper([p], [g], [m], [v], bc1s=[bc1], bc2s=[bc2], steps=[t], leaves=[0], bases=[base],
                    weight_decay=0.0, **HP)
            fused_adam.adam_update_reference(*plain[0], weight_decay=0.0, bc1=bc1, bc2=bc2, step=t,
                                             leaf=0, base=base, **HP)
            torch.cuda.synchronize()
            _, step_dm, step_dv = max_diffs(kern, plain)
            # p relative to max(1, |p|): a zero second moment beside a non-zero
            # first one (three of the 57M seeded v are 0) steps p by lr * m / eps,
            # to |p| ~ 1e4, whose float32 ulp is 1e-3
            step_dp = float(((kern[0][0] - plain[0][0]).abs() / plain[0][0].abs().clamp(min=1)).max())
            dp, dm, dv = (max(a, b) for a, b in zip((dp, dm, dv), (step_dp, step_dm, step_dv)))
            if bf16:
                out, n_apart = bf16_moment_check(kern, plain, before, 0.0)
                outside, apart = outside + out, apart + n_apart
            del before, plain
        detail = f"max|dp|/max(1,|p|)={dp:.3g} max|dm|={dm:.3g} max|dv|={dv:.3g}"
        if bf16:
            moments_ok = outside == 0 and (apart == 0 or not zero_grad)
            detail += (f"; moments stored differently (each a bf16 neighbour of the plain float32 "
                       f"moment): {apart} of {STEPS * 2 * n}" + (" (bitwise)" if zero_grad else "")
                       + f", {outside} outside their bounds")
        else:
            moments_ok = dm <= MOMENT_TOL and dv <= MOMENT_TOL
        label = f"base {base}" + (", zero gradients" if zero_grad else "")
        if not (dp <= P_TOL and moments_ok):
            raise SystemExit(f"chip_smoke: the flat-shard launch of {KERNEL_NAMES[wrapper.moment_dtype]} "
                             f"disagrees with its plain version ({label}): {detail}")
        errs.append(dp)
        phase("11 flat shard", f"{KERNEL_NAMES[wrapper.moment_dtype]} flat-shard launch vs plain, one row "
              f"of {n} elements, {label}, {STEPS} steps: {detail}")
        del kern
        torch.cuda.empty_cache()
    return max(errs)


def flat_time(wrapper, alexnet_shapes, bw, flops):
    """Phase 11: one AlexNet Adam update as one flat row, timed in turns
    with the plain version, with the per-leaf launch over the 16 leaves
    and, for float32 moments, with ``torch.optim.Adam(fused=True)`` over the
    one flat tensor; beside the bound of the bytes and operations."""
    bf16 = wrapper.moment_dtype == torch.bfloat16
    n = sum(math.prod(s) for s in alexnet_shapes)
    (p, g, m, v), = make_leaves([(n,)], seed=1, moments=wrapper.moment_dtype)
    leaves = make_leaves(alexnet_shapes, seed=1, moments=wrapper.moment_dtype)
    lps, lgs, lms, lvs = (list(x) for x in zip(*leaves))
    bc1, bc2 = fused_adam.bias_corrections(1, HP["betas"])
    k = len(alexnet_shapes)
    fns = {
        "plain": partial(fused_adam.adam_update_reference, p, g, m, v, weight_decay=0.0, bc1=bc1,
                         bc2=bc2, step=1, leaf=0, **HP),
        "flat": partial(wrapper, [p], [g], [m], [v], bc1s=[bc1], bc2s=[bc2], steps=[1], leaves=[0],
                        bases=[0], weight_decay=0.0, **HP),
        "leaves": partial(wrapper, lps, lgs, lms, lvs, bc1s=[bc1] * k, bc2s=[bc2] * k, steps=[1] * k,
                          leaves=list(range(k)), weight_decay=0.0, **HP),
    }
    order = ("plain", "flat", "leaves", "leaves", "flat", "plain")
    if not bf16:
        prm = torch.nn.Parameter(p.clone())
        prm.grad = g.clone()
        fns["library"] = torch.optim.Adam([prm], fused=True, **HP).step
        order = ("plain", "flat", "leaves", "library", "library", "leaves", "flat", "plain")
    runs = {key: [] for key in fns}
    for key in order:
        runs[key].append(time_ms(fns[key]))
    best = {key: min(r) for key, r in runs.items()}
    nbytes = (3 * 4 + 4 * m.element_size()) * n
    bytes_ms = nbytes / bw * 1e3
    ops_ms = (ADAM_OPS_PER_ELEMENT + (2 * ROUNDING_OPS_PER_MOMENT if bf16 else 0)) * n / flops * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    flat_ms, flat_enq = best["flat"]
    library_ms = best["library"][0] if "library" in best else None
    each = " ".join(f"{key}=" + ",".join(f"{t:.4f}" for t, _ in runs[key]) for key in fns)
    phase("11 flat shard", f"one AlexNet Adam update as one flat row, {KERNEL_NAMES[wrapper.moment_dtype]} "
          f"({n} elements, {nbytes / 1e9:.3f} GB), best of two in turns: flat_ms={flat_ms:.4f} "
          f"enqueue_ms={flat_enq:.4f} leaves_ms={best['leaves'][0]:.4f} (16 leaves, one launch) "
          + (f"library_ms={library_ms:.4f} " if library_ms is not None else "")
          + f"plain_ms={best['plain'][0]:.4f} bound_ms={bound_ms:.4f} "
          f"({100 * bound_ms / flat_ms:.1f}% of bound); each run: {each}")
    out = dict(ms=flat_ms, plain_ms=best["plain"][0], library_ms=library_ms, bound_ms=bound_ms,
               bound_by="bytes" if bytes_ms >= ops_ms else "operations", enqueue_ms=flat_enq,
               leaves_ms=best["leaves"][0], elements=n)
    del p, g, m, v, leaves, lps, lgs, lms, lvs, fns
    torch.cuda.empty_cache()
    return out


def zero1_vs_replicated(comm_hook: str = "none", tag: str = "11 ZeRO-1 vs replicated"):
    """Phase 11: 3 AlexNet@224 b128 float32 steps without the clip from one
    state, native and managed, with and without ZeRO-1: bitwise expected
    (Adam is elementwise, the bias corrections the same), failing beyond
    1e-6; the ZeRO-1 launches each a table of one row. Phase 12: the native
    pair with `comm_hook` (its cast is elementwise too), the residuals
    (permuted into one order) held alike."""
    torch.manual_seed(0)
    init = {key: val.clone() for key, val in AlexNet(num_classes=10).state_dict().items()}
    gen = torch.Generator().manual_seed(1)
    batches = [(torch.randint(0, 256, (128, 32, 32, 3), dtype=torch.uint8, generator=gen).numpy(),
                torch.randint(0, 10, (128,), generator=gen).numpy(), np.ones(128, np.float32))
               for _ in range(3)]
    augment = make_train_augment(size=224, flip=False)

    def fresh():
        model = AlexNet(num_classes=10)
        model.load_state_dict(init)
        return model.cuda()

    residuals = []

    def native(zero1):
        model = fresh()
        ddp = DistributedDataParallel(model, Adam(model.parameters(), lr=1e-3), CrossEntropyLoss(),
                                      augment=augment, device="cuda", weight_update_sharding=zero1,
                                      comm_hook=comm_hook)
        torch.cuda.manual_seed(7)
        for batch in batches:
            ddp.train_step(batch)
        if ddp.residual is not None:  # in the JAX flat order
            r = ddp.residual.cpu().numpy()
            residuals.append(flat_to_jax("alexnet", model, r) if zero1 else r)
        return model

    def managed(zero1):
        acc = Accelerator(seed=0, augment=augment, device="cuda", weight_update_sharding=zero1)
        module = fresh()
        model, opt = acc.prepare(module, Adam(module.parameters(), lr=1e-3))
        torch.cuda.manual_seed(7)
        for x, y, w in batches:
            opt.zero_grad()
            acc.backward(CrossEntropyLoss()(model(x), y, w))
            opt.step()
        return model.module

    out = {"max_abs_dp": {}, "launches": {}}
    runs = (("native", native),) if comm_hook != "none" else (("native", native), ("managed", managed))
    for path, run in runs:
        diffs, rows = [], None
        for zero1 in (False, True):
            reset_counts()
            model = run(zero1)
            torch.cuda.synchronize()
            launches, table_rows = fused_adam.kernel.launches, dict(fused_adam.kernel.table_rows)
            out["launches"][f"{path} {'ZeRO-1' if zero1 else 'replicated'}"] = launches
            diffs.append({key: val.clone() for key, val in model.state_dict().items()})
            if zero1:
                rows = (launches, table_rows)
            del model
        dp = max(float((a - b).abs().max()) for a, b in zip(diffs[0].values(), diffs[1].values()))
        dr = float(np.abs(residuals[0] - residuals[1]).max()) if residuals else 0.0
        if not (dp <= 1e-6 and dr <= 1e-6 and rows == (3, {1: 3})):
            raise SystemExit(f"chip_smoke: {path} ZeRO-1 vs replicated ({comm_hook}): max|dp|={dp:.3g} "
                             f"max|d residual|={dr:.3g} (tolerance 1e-6), ZeRO-1 launches and tables by "
                             f"rows {rows} (expected 3, {{1: 3}})")
        out["max_abs_dp"][path] = dp
        out["max_abs_d_residual"] = dr
        hooked = f", comm_hook {comm_hook} (max|d residual|={dr:.3g})" if residuals else ""
        phase(tag, f"{path}: 3 AlexNet@224 b128 float32 steps from one state{hooked}, "
              f"ZeRO-1 at world 1 against the replicated step: max|dp|={dp:.3g} "
              f"({'bitwise' if dp == dr == 0 else 'NOT bitwise'}); ZeRO-1 launches {rows[0]}, tables by rows {rows[1]}")
        del diffs
        torch.cuda.empty_cache()
    return out


def stem_turns(first_s2d):
    """Phase 11: ``alexnet_s2d`` against ``alexnet`` from one state (max |d
    logits|, float32 at 224 px, eval mode), and the fast file against the
    same file at ``model: alexnet`` in turns, 3 epochs each (the first s2d
    turn is the fast-file run): epoch-3 (replayed) step medians."""
    torch.manual_seed(0)
    plain = AlexNet(num_classes=10).cuda().eval()
    s2d = load_model("alexnet_s2d", 10).cuda().eval()
    s2d.load_state_dict(plain.state_dict())
    x = torch.randn(32, 224, 224, 3, device="cuda", generator=torch.Generator(device="cuda").manual_seed(3))
    with torch.no_grad():
        a, b = plain(x), s2d(x)
    dlogits = float((a - b).abs().max())
    scale = float(a.abs().max())
    if not dlogits <= 1e-4 * scale:
        raise SystemExit(f"chip_smoke: alexnet_s2d logits part from alexnet's by {dlogits} (scale {scale})")
    del plain, s2d, x, a, b
    settings, training = training_for(SETTINGS_FAST)
    training["num_epochs"] = 3
    medians = {"s2d": [statistics.median(first_s2d[2]["step_ms"])], "alexnet": []}
    launches = {"s2d": 0, "alexnet": 0}
    for mode in STEM_TURNS[1:]:
        run = dict(training, model="alexnet_s2d" if mode == "s2d" else "alexnet")
        history, n, g, _ = _native_turn_run(run, "replay", settings)
        if not (n == 48 and all(math.isfinite(r["train_loss"]) for r in history)):
            raise SystemExit(f"chip_smoke: stem turn {mode}: launches {n}, history {history}")
        medians[mode].append(statistics.median(history[2]["step_ms"]))
        launches[mode] += n
    fmt = lambda xs: ", ".join(f"{t:.3f}" for t in xs)
    phase("11 stem", f"alexnet_s2d vs alexnet from one state, float32 eval logits at 224 px (batch 32): "
          f"max|d logits|={dlogits:.3g} (largest logit {scale:.3g}); the fast file at alexnet_s2d and at "
          f"alexnet in turns {'/'.join(STEM_TURNS)}, epoch-3 step median ms (bf16, replayed): "
          + "; ".join(f"{m} [{fmt(v)}]" for m, v in medians.items())
          + f" (s2d/alexnet {min(medians['s2d']) / min(medians['alexnet']):.3f}, least of each)")
    return dict(max_abs_d_logits=dlogits, largest_logit=scale, step_ms_medians=medians, launches=launches)


T0 = time.perf_counter()


# ---------------------------------------------------------------- phase 12 --

HOOKS = ("bf16", "bf16_ef", "int8_ef", "topk_ef")
HOOK_TURNS = ("none",) + HOOKS + HOOKS[::-1] + ("none",)
HOOK_ITERS = 20


def _alexnet_gradient(seed: int = 0):
    """One AlexNet float32 gradient and a non-zero residual from a seed, on
    the CPU: each parameter's gradient (port layout) normal at a scale of
    its own (10^-3 to 1), the residual 1e-3 of it."""
    gen = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        shapes = [tuple(p.shape) for p in AlexNet(num_classes=10).parameters()]
    grads = []
    for shape in shapes:
        scale = 10.0 ** (-3 * float(torch.rand((), generator=gen)))
        grads.append(torch.randn(shape, generator=gen) * scale)
    residual = [torch.randn(shape, generator=gen) * 1e-3 for shape in shapes]
    return grads, residual


def _hook_agree(hook, send, card, cpu, buckets, density):
    """``(agree, ties)``: the card's and the CPU's outputs of one hook are
    equal, NaN where NaN; for topk_ef, but at elements whose magnitude is
    their bucket's top-k threshold, where the two topk implementations may
    keep different ones of equal magnitude (``ties`` counts them)."""
    card = card.cpu()
    nans = torch.equal(card.isnan(), cpu.isnan())
    differ = card.nan_to_num(0.0) != cpu.nan_to_num(0.0)
    if not differ.any():
        return nans, 0
    if hook != "topk_ef":
        return False, 0
    mag, ties = send.abs(), 0
    for s, e in buckets:
        d = differ[s:e]
        if d.any():
            k = comm.bucket_topk(e - s, density)
            threshold = mag[s:e].kthvalue(e - s - k + 1).values
            if not bool((mag[s:e][d] == threshold).all()):
                return False, 0
            ties += int(d.sum())
    return nans, ties


def hooks_vs_plain():
    """Phase 12: each hook's native exchange (``GradComm.reduce`` over the
    JAX-ordered AlexNet vector, its five buckets) and managed round trip
    (``local_quantize``, each of the 16 parameters its own bucket) on the
    card against the same port functions on the CPU, from one gradient
    and a non-zero residual; an all-zero bucket and a bucket holding a
    NaN; then each hook's round trip on the card (``comm_sync``: flatten,
    into the JAX order, exchange, back) timed in turns with the plain
    sync's flatten and copy back."""
    grads, res_tree = _alexnet_gradient()
    with torch.device("meta"):
        meta = AlexNet(num_classes=10)
    order = JaxFlatOrder("alexnet", meta, device="cpu")
    g_vec = order.to_jax(torch.cat([g.reshape(-1) for g in grads]))
    r_vec = order.to_jax(torch.cat([r.reshape(-1) for r in res_tree]))
    sizes = jax_sizes("alexnet", meta)
    buckets = comm.make_grad_comm(sizes, 1, "bf16").buckets
    zero = buckets[2]  # classifier.4's bias
    poisoned = {"plain": g_vec, "zero bucket": g_vec.clone(), "nan bucket": g_vec.clone()}
    poisoned["zero bucket"][zero[0]:zero[1]] = 0
    poisoned["nan bucket"][buckets[-1][0] + 3] = float("nan")
    out = {}
    for hook in HOOKS:
        plan = comm.make_grad_comm(sizes, 1, hook)
        row = {"native_ties": 0}
        for case, g in poisoned.items():
            res = {d: r_vec.to(d, copy=True) if plan.needs_residual else None for d in ("cpu", "cuda")}
            cpu_out, _ = plan.reduce(g, res["cpu"])
            card_out, _ = plan.reduce(g.cuda(), res["cuda"])
            torch.cuda.synchronize()
            send = g if res["cpu"] is None else g + r_vec
            pairs = [(card_out, cpu_out)] + ([(res["cuda"], res["cpu"])] if plan.needs_residual else [])
            for card, cpu in pairs:
                ok, ties = _hook_agree(hook, send, card, cpu, plan.buckets, plan.density)
                if not ok:
                    raise SystemExit(f"chip_smoke: hook {hook} ({case}) on the card disagrees with the CPU")
                row["native_ties"] += ties
            if case == "zero bucket" and hook == "bf16" and cpu_out[zero[0]:zero[1]].any():
                raise SystemExit("chip_smoke: bf16's all-zero bucket sent non-zeros")
            if case == "nan bucket":
                s, e = plan.buckets[-1]
                nans = int(cpu_out[s:e].isnan().sum())
                want = {"bf16": 1, "bf16_ef": 1, "int8_ef": e - s,
                        "topk_ef": comm.bucket_topk(e - s, plan.density)}[hook]
                if nans != want:
                    raise SystemExit(f"chip_smoke: hook {hook}: {nans} NaN in the poisoned bucket, want {want}")
                row["nan_bucket_nans"] = nans
        residual = [r.clone() for r in res_tree] if hook in comm.EF_HOOKS else None
        cpu_q, cpu_r = comm.local_quantize(grads, residual, hook)
        card_q, card_r = comm.local_quantize([g.cuda() for g in grads],
                                             None if residual is None else [r.cuda() for r in residual], hook)
        row["managed_ties"] = 0
        sends = grads if residual is None else [g + r for g, r in zip(grads, res_tree)]
        for card, cpu, send in zip(card_q + (card_r or []), cpu_q + (cpu_r or []), sends + sends):
            ok, ties = _hook_agree(hook, send.reshape(-1), card.reshape(-1), cpu.reshape(-1),
                                   ((0, send.numel()),), plan.density)
            if not ok:
                raise SystemExit(f"chip_smoke: managed hook {hook} on the card disagrees with the CPU")
            row["managed_ties"] += ties
        out[hook] = row
        del cpu_out, card_out, cpu_q, cpu_r, card_q, card_r
    # the round trips, in turns
    model = AlexNet(num_classes=10).cuda()
    params = list(model.parameters())
    card_order = JaxFlatOrder("alexnet", model)
    card_grads = [g.cuda() for g in grads]
    times = {h: [] for h in ("none",) + HOOKS}
    for hook in HOOK_TURNS:
        plan = comm.make_grad_comm(sizes, 1, hook)
        residual = None if plan is None else plan.init_residual("cuda")

        def once():
            for p, g in zip(params, card_grads):
                p.grad = g
            if plan is None:  # the plain sync's flatten and copy back, its collective excepted
                collectives.flat_collective([p.grad for p in params], lambda flat: None)
            else:
                comm_sync(params, plan, card_order, residual)

        for _ in range(3):  # warm-up
            once()
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(HOOK_ITERS)]
        for start, stop in events:
            start.record()
            once()
            stop.record()
        torch.cuda.synchronize()
        times[hook] += [start.elapsed_time(stop) for start, stop in events]
    for hook in ("none",) + HOOKS:
        out.setdefault(hook, {})["round_trip_ms"] = statistics.median(times[hook])
        out[hook]["round_trip_ms_quartiles"] = statistics.quantiles(times[hook], n=4)
    del model, params, card_grads
    torch.cuda.empty_cache()
    phase("12 hooks vs plain", "AlexNet's gradient (57,044,810 elements, five JAX-order buckets) and a "
          "non-zero residual: every hook's native exchange and managed round trip on the card equal to "
          "the CPU's (bf16 and int8 bitwise, topk kept vectors equal but at threshold ties: "
          + ", ".join(f"{h} {out[h]['native_ties']}/{out[h]['managed_ties']}" for h in HOOKS)
          + "); the all-zero bucket and the NaN bucket as the JAX package gives them; round trip "
          + ", ".join(f"{h} {out[h]['round_trip_ms']:.3f} ms" for h in ("none",) + HOOKS)
          + f" (comm_sync on the card, the median of {2 * HOOK_ITERS} calls timed each, in 2 turns; none: "
          "the plain sync's flatten and copy back)")
    return out


def _epoch_1_tol(hook: str, key: str, base: float) -> float:
    """The bound of a hook's epoch-1 loss around the float32 run's:
    ``loss_parity_tol``; int8_ef's train loss takes the bound it gives
    topk_ef's warm-up lag (see PARITY_AS)."""
    return comm.loss_parity_tol(PARITY_AS.get((hook, key), hook), base)


# One max-abs scale over AlexNet's 37.7M-element bucket rounds every element
# under 1/254 of the bucket's largest to code 0, so int8_ef's first updates
# send a sparse gradient and the rest waits in the residual: the warm-up lag
# that loss_parity_tol allows topk_ef. The JAX package's own int8_ef run of
# this cell leaves its float32 run's epoch-1 train loss by 0.158-0.159 (two
# runs), three times the dense bound 0.055 (tools/jax_hook_epochs.py, the
# JAX package on the H100).
PARITY_AS = {("int8_ef", "train_loss"): "topk_ef"}


def native_hooks():
    """Phase 12: 3 epochs of cifar10_alexnet_h100.yaml at ``scan_steps:
    auto`` with each hook: one Adam launch per update, the losses finite,
    epoch 1's within ``loss_parity_tol`` of the float32 run's 2.9944 /
    2.3076 (int8_ef's train loss within the warm-up-lag bound), the
    replayed step median."""
    out = {}
    for hook in HOOKS:
        history, wall_s, launches = native_run(SETTINGS, {"num_epochs": 3, "comm_hook": hook})
        steps = check_epochs(f"comm_hook {hook}", history, launches, fused_adam.kernel, False)
        first = history[0]
        gaps = [abs(first[k] - base) - _epoch_1_tol(hook, k, base)
                for k, base in zip(("train_loss", "test_loss"), F32_LOSSES)]
        if max(gaps) > 0 or first["comm_hook"] != hook:
            raise SystemExit(f"chip_smoke: native {hook} epoch 1 off the float32 losses: {first}")
        steady = statistics.median(history[-1]["step_ms"])
        out[hook] = dict(launches=launches[fused_adam.kernel.symbol], steps=steps,
                         epochs=[(r["train_loss"], r["test_loss"]) for r in history],
                         step_ms_median=steady,
                         grad_comm_bytes_per_update=first["grad_comm_bytes_per_update"],
                         grad_comm_bytes_per_update_f32=first["grad_comm_bytes_per_update_f32"])
        phase("12 native hooks", f"cifar10_alexnet_h100.yaml comm_hook {hook}, 3 epochs: {steps} steps, "
              f"fused_adam launches={out[hook]['launches']}; epoch 1 train_loss={first['train_loss']:.4f} "
              f"test_loss={first['test_loss']:.4f} (float32 run 2.9944 / 2.3076, within "
              + " / ".join(f"{_epoch_1_tol(hook, k, b):.4f}"
                           for k, b in zip(("train_loss", "test_loss"), F32_LOSSES))
              + f"); epoch 3 {history[-1]['train_loss']:.4f} / {history[-1]['test_loss']:.4f}; "
              f"step_ms epoch 3 (replayed) {steady:.2f}; wall {wall_s:.2f} s")
    return out


def hooked_chunk_pairs():
    """Phase 12: 3 AlexNet chunks of 8 with bf16_ef and with topk_ef through
    replay and eagerly from one state: parameters, moments and the
    residual bitwise."""
    gen = torch.Generator().manual_seed(1)
    batches = [(torch.randint(0, 256, (128, 32, 32, 3), dtype=torch.uint8, generator=gen).numpy(),
                torch.randint(0, 10, (128,), generator=gen).numpy(), np.ones(128, np.float32))
               for _ in range(24)]

    def alex():
        torch.manual_seed(0)
        g = torch.Generator().manual_seed(1)
        return AlexNet(num_classes=10), make_train_augment(size=224, flip=True, generator=g), g, "alexnet"

    return [native_chunk_pair(f"AlexNet@224 b128 flip dropout adam, comm_hook {hook}", alex, batches, 8,
                              comm_hook=hook, tag="12 graph vs eager") for hook in ("bf16_ef", "topk_ef")]


def managed_hooks():
    """Phase 12: managed AlexNet@224 b128 with int8_ef, 3 flushes of 8
    from one state through the fused graph replay and the eager queue:
    bitwise, the residual included."""
    mean = CrossEntropyLoss()
    gen = torch.Generator().manual_seed(1)
    batches = [(torch.randint(0, 256, (128, 32, 32, 3), dtype=torch.uint8, generator=gen).numpy(),
                torch.randint(0, 10, (128,), generator=gen).numpy(), np.ones(128, np.float32), mean)
               for _ in range(24)]

    def alex():
        acc = Accelerator(seed=0, fuse_steps=8, device="cuda", comm_hook="int8_ef")
        acc.augment = make_train_augment(size=224, flip=True, generator=acc.generator)
        torch.manual_seed(0)
        return acc, AlexNet(num_classes=10), "alexnet"

    pair = graph_vs_eager("managed AlexNet@224 b128 flip dropout adam, comm_hook int8_ef", alex, batches, 8,
                          tag="12 managed hooks")
    if not pair["bitwise"]:
        raise SystemExit(f"chip_smoke: managed int8_ef replay is not bitwise its eager queue: {pair}")
    return pair


def zero1_hooks():
    """Phase 12: the fast file (alexnet_s2d, bf16 compute and moments,
    ZeRO-1) with bf16_ef for 3 epochs; and at world 1 the ZeRO-1 step with
    bf16_ef bitwise the replicated one (float32 moments: bf16 ones round
    with noise keyed by the layout, which the two paths number apart)."""
    bf16 = fused_adam.kernels[torch.bfloat16]
    history, wall_s, launches = native_run(SETTINGS_FAST, {"num_epochs": 3, "comm_hook": "bf16_ef"})
    steps = check_epochs("the fast file with bf16_ef", history, launches, bf16, False)
    if set(bf16.table_rows) != {1}:
        raise SystemExit(f"chip_smoke: the fast file with bf16_ef built tables of rows {bf16.table_rows}")
    last = history[-1]
    phase("12 ZeRO-1 hooks", f"cifar10_alexnet_fast_h100.yaml with comm_hook bf16_ef, 3 epochs: {steps} "
          f"steps, {bf16.symbol} launches={launches[bf16.symbol]}; "
          + ", ".join(f"epoch {r['epoch'] + 1} {r['train_loss']:.4f}/{r['test_loss']:.4f}" for r in history)
          + f"; step_ms epoch 3 (replayed) {statistics.median(last['step_ms']):.2f}; wall {wall_s:.2f} s")
    pair = zero1_vs_replicated("bf16_ef", tag="12 ZeRO-1 hooks")
    return dict(launches=launches[bf16.symbol], step_ms_median=statistics.median(last["step_ms"]),
                epochs=[(r["train_loss"], r["test_loss"]) for r in history], vs_replicated=pair)


def hooked_resume(kind: str, root: str):
    """Phase 12: digits_h100.yaml with int8_ef for 2 epochs straight against
    epoch 0 and a resumed epoch 1: every array of the last file equal, the
    residual included."""
    worker = basic_ddp_training_loop if kind == "native" else basic_accelerate_training
    prefix = ckpt.PREFIX[ckpt.NATIVE if kind == "native" else ckpt.MANAGED]
    straight, resumed = os.path.join(root, kind, "straight"), os.path.join(root, kind, "resumed")

    def run(save_dir, **more):
        settings, training = _fused_settings(SETTINGS_DIGITS, comm_hook="int8_ef", checkpoint_epoch=1,
                                             **more)
        os.makedirs(save_dir, exist_ok=True)
        reset_counts()
        history = run_ddp_training(partial(worker, training=training, device="cuda"), 1, save_dir,
                                   cfg_lib.optional_args_from(settings), backend="cuda")
        torch.cuda.synchronize()
        return history, fused_adam.kernel.launches

    whole, _ = run(straight, num_epochs=2)
    run(resumed, num_epochs=1)
    again, launches = run(resumed, num_epochs=2, resume=True)
    a, b = _arrays(os.path.join(straight, f"{prefix}_1.npz")), _arrays(os.path.join(resumed, f"{prefix}_1.npz"))
    residual = [k for k in a if "comm_state" in k]
    checks = {
        "epoch 1 resumed alone": [r["epoch"] for r in again] == [1],
        "epoch 1's losses equal": (again[0]["train_loss"], again[0]["test_loss"]) == (
            whole[1]["train_loss"], whole[1]["test_loss"]),
        "every array equal, the residual included": bool(residual) and sorted(a) == sorted(b) and all(
            np.array_equal(a[k], b[k]) for k in a),
        "a non-zero residual": any(np.any(a[k] != 0) for k in residual),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 12 resume ({kind}) failed {failed}: straight={whole}, resumed={again}")
    phase("12 resume", f"{kind} digits_h100.yaml with comm_hook int8_ef: epoch 1 resumed from "
          f"{prefix}_0.npz equal to the straight run (train_loss={again[0]['train_loss']:.4f}), every array "
          f"of {prefix}_1.npz equal, {len(residual)} residual array(s) among them; {launches} fused_adam "
          f"launches in the resumed run")
    return launches


def hook_bytes():
    """Each hook's gradient wire bytes per update on AlexNet: the native
    wrap's counters at world 1, and the analytic count at world 8."""
    with torch.device("meta"):
        sizes = jax_sizes("alexnet", AlexNet(num_classes=10))
    return {hook: {"world_1": comm.comm_bytes_for_hook(sizes, 1, hook),
                   "world_1_f32": comm.comm_bytes_for_hook(sizes, 1, "none"),
                   "world_8": comm.comm_bytes_for_hook(sizes, 8, hook),
                   "world_8_f32": comm.comm_bytes_for_hook(sizes, 8, "none")}
            for hook in ("none",) + HOOKS}

# ---------------------------------------------------------------- phase 13 --

# each hook's segmented step against its barrier step (AlexNet at
# bucket_cap_mb 25: three segments); (step, replay) in the order of the runs
OVERLAP_HOOKS = ("none",) + HOOKS
OVERLAP_RUNS = (("barrier", False), ("segmented", False), ("segmented", True), ("barrier", True))
OVERLAP_K, OVERLAP_CHUNKS, OVERLAP_ROUNDS = 4, 3, 8


def _overlap_ddp(hook: str, overlap, replay: bool, init, accum: int = 1, cap: float = 25.0):
    """The native AlexNet wrap of phase 13 holding the weights ``init``."""
    with torch.device("meta"):
        model = AlexNet(num_classes=10)
    model.to_empty(device="cuda").load_state_dict(init)
    gen = torch.Generator().manual_seed(1)
    ddp = DistributedDataParallel(model, Adam(model.parameters(), lr=1e-3), CrossEntropyLoss(),
                                  augment=make_train_augment(size=224, flip=True, generator=gen),
                                  device="cuda", generator=gen, grad_accumulation=accum, comm_hook=hook,
                                  bucket_cap_mb=cap, comm_overlap=overlap)
    ddp._graph_replay = replay
    return ddp


def _ddp_state(ddp):
    """Parameters, the last update's gradients, Adam's moments and the
    residual, cloned."""
    state = {}
    for n, p in ddp.model.named_parameters():
        state[f"param/{n}"] = p.detach().clone()
        state[f"grad/{n}"] = p.grad.clone()
    for i, st in enumerate(ddp.optimizer.state.values()):
        state.update({f"moment/{i}/{k}": t.clone() for k, t in st.items() if torch.is_tensor(t) and t.numel() > 1})
    if ddp.residual is not None:
        state["residual"] = ddp.residual.clone()
    return state


def _union(spans):
    """The union of ``(start, end)`` spans as sorted disjoint spans."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def stream_overlap(ddp, batches, replay: bool):
    """One chunk (eager, or replayed) under ``torch.profiler``: the device
    streams that ran kernels, the busiest one's busy ms (eagerly: the
    backward's stream), the others' (eagerly: the side stream), and the ms
    in which the busiest and another ran kernels at once. A replay's
    kernels run on streams the driver picks for the graph's nodes, so there
    only the last number says something. Not measured where the trace holds
    no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    was, ddp._graph_replay = ddp._graph_replay, replay
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ddp.train_step_many(batches)
        torch.cuda.synchronize()
    ddp._graph_replay = was
    streams = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            streams.setdefault(e.device_resource_id, []).append((e.time_range.start, e.time_range.end))
    if not streams:
        return {"not_measured": "the trace holds no device events"}
    unions = {s: _union(v) for s, v in streams.items()}
    busy = {s: sum(b - a for a, b in u) / 1e3 for s, u in unions.items()}
    main = max(busy, key=busy.get)
    others = _union([iv for s, u in unions.items() if s != main for iv in u])
    both = sum(max(0.0, min(b, d) - max(a, c)) for a, b in unions[main] for c, d in others)
    return {"streams": len(streams), "kernels": sum(len(v) for v in streams.values()),
            "busiest_busy_ms": busy[main], "others_busy_ms": sum(v for s, v in busy.items() if s != main),
            "concurrent_ms": both / 1e3}


def overlap_pair(hook: str, batches, init, accum: int = 1, rounds: int = OVERLAP_ROUNDS,
                 trace: bool = False):
    """Phase 13 for one hook: 3 chunks of 4 AlexNet@224 b128 float32 steps
    (A = ``accum``) from the weights ``init``, barrier eagerly (the reference),
    segmented eagerly, segmented replayed and barrier replayed: max |d|
    over parameters, gradients, moments and the residual, which must be
    0; one Adam launch per update and 1 capture, 2 replays per replayed
    run; then the two replayed wraps' chunks timed in turns (barrier,
    segmented, segmented, barrier; ``rounds`` times) as step medians."""
    started = time.perf_counter()
    k, updates = OVERLAP_K, OVERLAP_K * OVERLAP_CHUNKS // accum
    states, launches, kinds, kept, meta, counts = {}, {}, {}, {}, None, None
    for label, replay in OVERLAP_RUNS:
        gc.collect()  # earlier wraps and their graphs, which cycles may hold
        torch.cuda.empty_cache()
        ddp = _overlap_ddp(hook, label == "segmented", replay, init, accum)
        if label == "segmented":
            meta = ddp.comm_overlap_meta
        torch.cuda.manual_seed(7)
        reset_counts()
        graphs.reset_stats()
        for c in range(OVERLAP_CHUNKS):
            ddp.train_step_many(batches[c * k:(c + 1) * k])
        torch.cuda.synchronize()
        run = f"{label} {'replay' if replay else 'eager'}"
        launches[run] = fused_adam.kernel.launches
        kinds[run] = _kinds(graphs.stats)
        states[run] = _ddp_state(ddp)
        if label == "segmented" and not replay:
            counts = dict(ddp._overlap.counts)
        if replay:
            kept[label] = ddp
        del ddp
    ref = states.pop("barrier eager")
    diff = {run: {part: max(float((st[key].double() - ref[key].double()).abs().max())
                            for key in ref if key.startswith(part))
                  for part in ("param", "grad", "moment", "residual") if any(key.startswith(part) for key in ref)}
            for run, st in states.items()}
    del states, ref
    checks = {
        "segmented: enabled, 3 segments": meta == {"enabled": True, "segments": 3, "reason": None},
        "every segment exchanged from inside the backward": counts == {"hook": 3 * updates, "join": 0},
        "max |d| = 0": all(v == 0.0 for d in diff.values() for v in d.values()),
        "1 launch per update": all(n == updates for n in launches.values()),
        "1 capture, 2 replays per replayed run": all(
            kinds[f"{label} replay"] == {"train": (1, OVERLAP_CHUNKS - 1)} for label in kept),
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 13 segmented vs barrier, {hook}, A={accum}, failed {failed}: "
                         f"meta {meta}, counts {counts}, diff {diff}, launches {launches}, graphs {kinds}")
    times = {"barrier": [], "segmented": []}
    reset_counts()
    for _ in range(rounds):
        for label in ("barrier", "segmented", "segmented", "barrier"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kept[label].train_step_many(batches[:k])
            torch.cuda.synchronize()
            times[label].append((time.perf_counter() - t0) * 1e3 / k)
    launches["turns"] = fused_adam.kernel.launches
    if launches["turns"] != 4 * rounds * k // accum:
        raise SystemExit(f"chip_smoke: 13 turns of {hook}: {launches['turns']} Adam launches")
    medians = {label: statistics.median(v) for label, v in times.items()}
    traced = None
    if trace:
        traced = {f"{label} {'replay' if replay else 'eager'}": stream_overlap(kept[label], batches[:k], replay)
                  for label in kept for replay in (False, True)}
    del kept
    torch.cuda.empty_cache()
    phase("13 segmented vs barrier", f"AlexNet@224 b128 float32 comm_hook {hook}, bucket_cap_mb 25, A={accum}, "
          f"{OVERLAP_CHUNKS} chunks of {k} from one state: comm_overlap_meta {meta}, segment exchanges "
          f"{counts} (eager run); max |d| vs the eager barrier run "
          + "; ".join(f"{run} " + " ".join(f"{p} {v:.3g}" for p, v in d.items()) for run, d in diff.items())
          + f" (bitwise); Adam launches {launches}; replayed step median barrier {medians['barrier']:.3f} "
          f"ms, segmented {medians['segmented']:.3f} ms ({rounds} rounds of b,s,s,b, {k} steps a chunk); "
          f"{time.perf_counter() - started:.1f} s")
    if traced is not None:
        phase("13 stream overlap", f"comm_hook {hook}, one chunk of {k} of each wrap under torch.profiler, "
              "eagerly and replayed: " + "; ".join(f"{label}: {json.dumps(t)}" for label, t in traced.items()))
    return dict(hook=hook, accum=accum, meta=meta, segment_exchanges=counts, max_abs_diff=diff,
                launches=launches, step_ms_median=medians, step_ms=times, trace=traced)


def overlap_phase():
    """Phase 13: every hook's segmented AlexNet step against its barrier
    step (eager and replayed), one A = 2 cycle with int8_ef, and the
    resolved plan at bucket_cap_mb 250 (one segment: the barrier step)."""
    gen = torch.Generator().manual_seed(3)
    batches = [(torch.randint(0, 256, (128, 32, 32, 3), dtype=torch.uint8, generator=gen).numpy(),
                torch.randint(0, 10, (128,), generator=gen).numpy(), np.ones(128, np.float32))
               for _ in range(OVERLAP_K * OVERLAP_CHUNKS)]
    torch.manual_seed(0)
    init = AlexNet(num_classes=10).state_dict()
    pairs = [overlap_pair(hook, batches, init, trace=hook == "int8_ef") for hook in OVERLAP_HOOKS]
    pairs.append(overlap_pair("int8_ef", batches, init, accum=2, rounds=1))
    single = _overlap_ddp("none", "auto", False, init, cap=250.0).comm_overlap_meta
    if single["enabled"] or "single bucket-aligned segment at bucket_cap_mb=250" not in single["reason"]:
        raise SystemExit(f"chip_smoke: AlexNet at bucket_cap_mb 250 resolved {single}")
    phase("13 plan", f"AlexNet, comm_overlap auto: bucket_cap_mb 25 {pairs[0]['meta']}; 250 {single}")
    torch.cuda.empty_cache()
    return {"pairs": pairs, "cap_250_meta": single}


# ---------------------------------------------------------------- phase 14 --

GUARD_K, GUARD_CHUNKS, GUARD_BAD = 8, 3, 3  # the last chunk's step 3 poisoned
GUARD_ROUNDS = 4
GUARD_COUNT = 6  # the device count of the kernel check: step 7


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


def _leaves_equal(a, b) -> bool:
    return all(torch.equal(_bits(x), _bits(y)) for la, lb in zip(a, b) for x, y in zip(la, lb))


def guard_kernel(wrapper, alexnet_shapes, bw, flops):
    """Phase 14: the kernel's guarded calling form at AlexNet's shapes: at
    verdict 1 bitwise the unguarded launch of the same step, at verdict 0
    nothing written and one launch counted; against its plain version
    (the guarded ``adam_update_reference``) within phase 3's bounds; timed
    in turns with the unguarded launch (and, float32, with
    ``torch.optim.Adam(fused=True)``), the skipped launch too."""
    bf16 = wrapper.moment_dtype == torch.bfloat16
    wd = 5e-4
    n = len(alexnet_shapes)
    leaves = make_leaves(alexnet_shapes, seed=14, moments=wrapper.moment_dtype)
    unguarded, applied, skipped, plain = clone(leaves), clone(leaves), clone(leaves), clone(leaves)
    one = torch.ones((), dtype=torch.int32, device="cuda")
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    count = torch.full((), GUARD_COUNT, dtype=torch.int32, device="cuda")

    def guarded(ls, verdict):
        ps, gs, ms, vs = (list(x) for x in zip(*ls))
        return partial(wrapper, ps, gs, ms, vs, leaves=leaf_indices(n), weight_decay=wd,
                       verdict=verdict, count=count, **HP)

    kernel_step(wrapper, unguarded, [GUARD_COUNT + 1] * n, wd)
    guarded(applied, one)()
    reset_counts()
    guarded(skipped, zero)()
    torch.cuda.synchronize()
    skip_launches = wrapper.launches
    for (p, g, m, v), k in zip(plain, leaf_indices(n)):
        fused_adam.adam_update_reference(p, g, m, v, weight_decay=wd, leaf=k, verdict=one,
                                         count=count, **HP)
    torch.cuda.synchronize()
    dp, dm, dv = max_diffs(applied, plain)
    checks = {
        "verdict 1 bitwise the unguarded launch at the same step": _leaves_equal(applied, unguarded),
        "verdict 0 writes nothing": _leaves_equal(skipped, leaves),
        "verdict 0 is one launch": skip_launches == 1,
        f"p within {P_TOL} of the plain version": dp <= P_TOL,
    }
    if bf16:
        outside, apart = bf16_moment_check(applied, plain, leaves, wd)
        checks["bf16 moments each a neighbour of the plain moment"] = outside == 0
        detail = f"max|dp|={dp:.3g}, bf16 moments stored differently {apart}, outside {outside}"
    else:
        checks[f"moments within {MOMENT_TOL}"] = dm <= MOMENT_TOL and dv <= MOMENT_TOL
        detail = f"max|dp|={dp:.3g} max|dm|={dm:.3g} max|dv|={dv:.3g}"
    failed = [c for c, ok in checks.items() if not ok]
    name = KERNEL_NAMES[wrapper.moment_dtype]
    if failed:
        raise SystemExit(f"chip_smoke: 14 guard kernel, {name}, failed {failed}: {detail}")
    del unguarded, skipped, plain
    # timing: the applied and the skipped guarded launch, the unguarded one
    ps, gs, ms, vs = (list(x) for x in zip(*applied))
    bcs = [fused_adam.bias_corrections(GUARD_COUNT + 1, HP["betas"])] * n
    fns = {
        "unguarded": partial(wrapper, ps, gs, ms, vs, bc1s=[b[0] for b in bcs],
                             bc2s=[b[1] for b in bcs], steps=[GUARD_COUNT + 1] * n,
                             leaves=leaf_indices(n), weight_decay=wd, **HP),
        "guarded": guarded(applied, one),
        "skipped": guarded(applied, zero),
        "plain": lambda: [fused_adam.adam_update_reference(
            p, g, m, v, weight_decay=wd, leaf=k, verdict=one, count=count, **HP)
            for (p, g, m, v), k in zip(applied, leaf_indices(n))],
    }
    order = ("plain", "unguarded", "guarded", "skipped", "skipped", "guarded", "unguarded", "plain")
    if not bf16:
        params = [torch.nn.Parameter(p.clone()) for p in ps]
        for prm, g in zip(params, gs):
            prm.grad = g.clone()
        fns["library"] = torch.optim.Adam(params, fused=True, **HP).step
        order = order[:4] + ("library", "library") + order[4:]
    runs = {k: [] for k in fns}
    for k in order:
        # the skipped launch's device work is shorter than its host enqueue
        runs[k].append(graph_ms(fns[k]) if k == "skipped" else time_ms(fns[k])[0])
    best = {k: min(r) for k, r in runs.items()}
    n_params = sum(math.prod(s) for s in alexnet_shapes)
    nbytes = (3 * 4 + 4 * ms[0].element_size()) * n_params  # applied: as the unguarded launch
    bytes_ms = nbytes / bw * 1e3
    ops_ms = (ADAM_OPS_PER_ELEMENT + (2 * ROUNDING_OPS_PER_MOMENT if bf16 else 0)) * n_params / flops * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    phase("14 guard kernel", f"{name}, AlexNet's {n} leaves ({n_params} params) at device count "
          f"{GUARD_COUNT}, wd={wd}: verdict 1 bitwise the unguarded step {GUARD_COUNT + 1}, verdict 0 "
          f"wrote nothing in {skip_launches} launch; vs plain: {detail}; best of two in turns: guarded "
          f"{best['guarded']:.4f} ms, unguarded {best['unguarded']:.4f} ms, skipped (replayed) "
          f"{best['skipped']:.4f} ms, "
          + (f"library {best['library']:.4f} ms, " if not bf16 else "")
          + f"plain {best['plain']:.4f} ms, bound {bound_ms:.4f} ms ({100 * bound_ms / best['guarded']:.1f}%)"
          f"; each run: " + " ".join(f"{k}=" + ",".join(f"{t:.4f}" for t in r) for k, r in runs.items()))
    return dict(ms=best["guarded"], plain_ms=best["plain"], bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=best.get("library"), unguarded_ms=best["unguarded"],
                skipped_ms=best["skipped"], max_abs_err=dp)


def guard_verdict(alexnet_shapes, bw):
    """Phase 14: the firewall's verdict over one AlexNet float32 gradient
    (16 leaves): the port's ``all_finite`` (one ``aminmax`` pass a leaf)
    timed in turns with ``isfinite(leaf).all()`` a leaf, each as a CUDA
    graph's replays (its device time, as in a replayed step; eagerly the
    host's launches set the pace) and eagerly, beside the bound of reading
    the gradient once; both give 1 on it and 0 with a NaN or an infinity."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    gs = [torch.randn(s, generator=gen, device="cuda") for s in alexnet_shapes]
    verdict = torch.ones((), dtype=torch.int32, device="cuda")
    fns = {"all_finite": lambda: verdict.copy_(guard_lib.all_finite(gs)),
           "isfinite_all": lambda: verdict.copy_(torch.stack([torch.isfinite(g).all() for g in gs]).all())}
    runs = {k: [] for k in fns}
    eager = {k: [] for k in fns}
    for k in ("isfinite_all", "all_finite", "all_finite", "isfinite_all"):
        runs[k].append(graph_ms(fns[k]))
        eager[k].append(time_ms(fns[k])[0])
    agree = []
    for leaf, value in ((None, None), (15, float("nan")), (3, float("inf")), (0, float("-inf"))):
        if leaf is not None:
            gs[leaf].view(-1)[-1] = value
        agree.append([int(fns[k]()) for k in fns])
        if leaf is not None:
            gs[leaf].view(-1)[-1] = 0.0
    if agree != [[1, 1], [0, 0], [0, 0], [0, 0]]:
        raise SystemExit(f"chip_smoke: 14 guard verdict disagrees: {agree}")
    n_params = sum(math.prod(s) for s in alexnet_shapes)
    bound_ms = 4 * n_params / bw * 1e3
    best = {k: min(r) for k, r in runs.items()}
    best_eager = {k: min(r) for k, r in eager.items()}
    phase("14 guard verdict", f"over one AlexNet gradient ({n_params} float32, 16 leaves), best of two "
          f"in turns, replayed from a CUDA graph: all_finite (aminmax) {best['all_finite']:.4f} ms, "
          f"isfinite().all() {best['isfinite_all']:.4f} ms, bound {bound_ms:.4f} ms (bytes); eagerly "
          f"{best_eager['all_finite']:.4f} / {best_eager['isfinite_all']:.4f} ms; verdicts "
          f"finite/nan/inf/-inf {agree}; each run: "
          + " ".join(f"{k}=" + ",".join(f"{t:.4f}" for t in r) for k, r in runs.items()))
    return dict(ms=best["all_finite"], isfinite_all_ms=best["isfinite_all"], bound_ms=bound_ms,
                bound_by="bytes", eager_ms=best_eager["all_finite"],
                isfinite_all_eager_ms=best_eager["isfinite_all"])


def _guard_batches(n, seed, poison=None):
    """``n`` CIFAR-sized batches (uint8 32x32 rows, b128: AlexNet resizes
    them on the card, the ResNets of phase 15 take them as they are); with ``poison`` the
    batch of that index through ``$TPUDDP_FAULT=nan@step=<poison>``'s
    injection (a NaN sample weight, as for every uint8 input)."""
    gen = torch.Generator().manual_seed(seed)
    batches = [(torch.randint(0, 256, (128, 32, 32, 3), dtype=torch.uint8, generator=gen).numpy(),
                torch.randint(0, 10, (128,), generator=gen).numpy(), np.ones(128, np.float32))
               for _ in range(n)]
    if poison is not None:
        os.environ["TPUDDP_FAULT"] = f"nan@step={poison}"
        faults.reload_faults()
        try:
            batches = [faults.maybe_corrupt_batch(b, i) for i, b in enumerate(batches)]
        finally:
            del os.environ["TPUDDP_FAULT"]
            faults.reload_faults()
        if math.isfinite(float(batches[poison][2][0])):
            raise SystemExit("chip_smoke: the nan@step injection poisoned nothing")
    return batches


def _guard_ddp(hook: str, guard, replay: bool, init):
    """Phase 14's native AlexNet wrap (float32, flips, dropout) from the
    weights ``init``; with a hook the segmented step (bucket_cap_mb 25)."""
    with torch.device("meta"):
        model = AlexNet(num_classes=10)
    model.to_empty(device="cuda").load_state_dict(init)
    gen = torch.Generator().manual_seed(1)
    ddp = DistributedDataParallel(model, Adam(model.parameters(), lr=1e-3), CrossEntropyLoss(),
                                  augment=make_train_augment(size=224, flip=True, generator=gen),
                                  device="cuda", generator=gen, comm_hook=hook, guard=guard)
    ddp._graph_replay = replay
    return ddp


def guard_chunk(hook: str, batches, clean, init):
    """Phase 14: 3 native AlexNet chunks of 8 guarded (the last with its
    step 3 poisoned) through CUDA-graph replay (warm-up, capture, replay)
    and eagerly, the eager run's last chunk cut around the poisoned step:
    every array bitwise, counters (1, 0), the skipped step a no-op (with a
    hook: every segment's residual span unchanged), one Adam launch per
    update; then the guarded and an unguarded replayed wrap's chunks in
    turns (guarded, unguarded, unguarded, guarded): step medians."""
    started = time.perf_counter()
    runs, noop = {}, None
    for mode in ("eager", "replay"):
        gc.collect()
        torch.cuda.empty_cache()
        ddp = _guard_ddp(hook, True, mode == "replay", init)
        torch.cuda.manual_seed(7)
        reset_counts()
        graphs.reset_stats()
        for c in range(GUARD_CHUNKS):
            chunk = batches[c * GUARD_K:(c + 1) * GUARD_K]
            if mode == "replay" or c < GUARD_CHUNKS - 1:
                ddp.train_step_many(chunk)
                continue
            ddp.train_step_many(chunk[:GUARD_BAD])
            before = _ddp_state(ddp)
            ddp.train_step_many(chunk[GUARD_BAD:GUARD_BAD + 1])
            after = _ddp_state(ddp)
            spans = ([seg.flat for seg in ddp._overlap.segments]
                     if ddp._overlap is not None and ddp.residual is not None else [])
            noop = {
                "state bitwise": all(torch.equal(before[k], after[k])
                                     for k in before if not k.startswith("grad/")),
                "counters (1, 1)": ddp.skip_counters() == (1, 1),
                "every segment's residual span armed and unchanged": all(
                    bool(before["residual"][a:b].abs().sum() > 0)
                    and torch.equal(before["residual"][a:b], after["residual"][a:b])
                    for a, b in spans),
            }
            del before, after
            ddp.train_step_many(chunk[GUARD_BAD + 1:])
        torch.cuda.synchronize()
        runs[mode] = (_ddp_state(ddp), ddp.skip_counters(), fused_adam.kernel.launches,
                      _kinds(graphs.stats), ddp.comm_overlap_meta)
        if mode == "replay":
            kept = ddp
        del ddp
    (eager, c_e, n_e, _, meta), (replay, c_r, n_r, g_r, _) = runs["eager"], runs["replay"]
    diff = max(float((eager[k].double() - replay[k].double()).abs().max()) for k in eager)
    updates = GUARD_K * GUARD_CHUNKS
    checks = {
        **{f"the skipped step: {k}": ok for k, ok in noop.items()},
        "replay bitwise eager (parameters, last gradients, moments, residual)": diff == 0.0,
        "counters (1, 0)": c_e == c_r == (1, 0),
        "1 launch per update, the skipped one too": n_e == n_r == updates,
        "1 capture, 2 replays": g_r == {"train": (1, GUARD_CHUNKS - 1)},
        "segmented (3 segments)": meta == {"enabled": True, "segments": 3, "reason": None},
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 14 guard chunk, {hook}, failed {failed}: max|d|={diff}, "
                         f"counters {c_e} {c_r}, launches {n_e} {n_r}, graphs {g_r}, meta {meta}")
    del runs, eager, replay
    plain = _guard_ddp(hook, None, True, init)
    for c in range(2):  # warm-up and capture of the unguarded wrap
        plain.train_step_many(clean[c * GUARD_K:(c + 1) * GUARD_K])
    wraps, times = {"guarded": kept, "unguarded": plain}, {"guarded": [], "unguarded": []}
    reset_counts()
    for _ in range(GUARD_ROUNDS):
        for label in ("guarded", "unguarded", "unguarded", "guarded"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wraps[label].train_step_many(clean[:GUARD_K])
            torch.cuda.synchronize()
            times[label].append((time.perf_counter() - t0) * 1e3 / GUARD_K)
    turns = fused_adam.kernel.launches
    medians = {label: statistics.median(v) for label, v in times.items()}
    quartiles = {label: statistics.quantiles(v, n=4) for label, v in times.items()}
    del wraps, kept, plain
    torch.cuda.empty_cache()
    phase("14 guard chunk", f"AlexNet@224 b128 float32 comm_hook {hook} (segmented, 3 segments), "
          f"guard on, {GUARD_CHUNKS} chunks of {GUARD_K}, step {GUARD_BAD} of the last poisoned "
          f"(nan@step={GUARD_K * (GUARD_CHUNKS - 1) + GUARD_BAD}): replay vs eager max |d| {diff:.3g} (bitwise), "
          f"counters {c_r}, the skipped step {noop}, launches replay {n_r} eager {n_e}, graphs {g_r}; "
          f"replayed step median guarded {medians['guarded']:.3f} ms, unguarded {medians['unguarded']:.3f} "
          f"ms (quartiles " + ", ".join(f"{k} {q[0]:.3f}-{q[2]:.3f}" for k, q in quartiles.items())
          + f"; {GUARD_ROUNDS} rounds of g,u,u,g; {turns} launches); {time.perf_counter() - started:.1f} s")
    return dict(hook=hook, segmented=meta["enabled"], max_abs_diff=diff, counters=list(c_r),
                launches={"replay": n_r, "eager": n_e, "turns": turns}, step_ms_median=medians,
                step_ms_quartiles=quartiles, step_ms=times)


def managed_guard(batches):
    """Phase 14: 3 managed AlexNet flushes of 8 guarded (the last holding
    the poisoned step) through the fused graph replay and the eager queue:
    bitwise, counters (1, 0), one launch per update, the skipped one too."""
    out = {}
    for mode in ("eager", "replay"):
        acc = Accelerator(seed=0, fuse_steps=GUARD_K, device="cuda", guard=True)
        acc.augment = make_train_augment(size=224, flip=True, generator=acc.generator)
        torch.manual_seed(0)
        module = AlexNet(num_classes=10)
        model, opt = acc.prepare(module, Adam(module.parameters(), lr=1e-3))
        opt._graph_replay = mode == "replay"
        torch.cuda.manual_seed(7)
        reset_counts()
        graphs.reset_stats()
        mean = CrossEntropyLoss()
        losses = []
        for x, y, w in batches:
            loss = mean(model(x), y, w)
            acc.backward(loss)
            opt.step()
            losses.append(loss)
        values = torch.stack([loss.device_value() for loss in losses]).cpu()
        torch.cuda.synchronize()
        out[mode] = (_pair_state(model, opt), values, opt.skip_counters(), fused_adam.kernel.launches,
                     dict(graphs.stats))
        del acc, module, model, opt, losses
        torch.cuda.empty_cache()
    (eager, l_e, c_e, n_e, _), (replay, l_r, c_r, n_r, g_r) = out["eager"], out["replay"]
    diff = max(float((eager[k].double() - replay[k].double()).abs().max()) for k in eager)
    losses_equal = torch.equal(l_e.view(torch.int32), l_r.view(torch.int32))
    checks = {
        "replay bitwise eager": diff == 0.0 and losses_equal,
        "the poisoned step's loss is not finite, every other one is": [
            bool(torch.isfinite(v)) for v in l_r] == [i != len(batches) - GUARD_K + GUARD_BAD
                                                        for i in range(len(batches))],
        "counters (1, 0)": c_e == c_r == (1, 0),
        "1 launch per update": n_e == n_r == len(batches),
        "1 capture, 2 replays": (g_r["captures"], g_r["replays"]) == (1, GUARD_CHUNKS - 1),
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 14 managed guard failed {failed}: max|d|={diff}, counters "
                         f"{c_e} {c_r}, launches {n_e} {n_r}, graphs {g_r}")
    phase("14 managed guard", f"managed AlexNet@224 b128 float32 flip dropout, fuse_steps {GUARD_K}, "
          f"guard on, {GUARD_CHUNKS} flushes, step {GUARD_BAD} of the last poisoned: replay vs eager "
          f"max |d| {diff:.3g}, losses bitwise, counters {c_r}, launches replay {n_r} eager {n_e}, "
          f"captures {g_r['captures']} replays {g_r['replays']}")
    return dict(max_abs_diff=diff, counters=list(c_r), launches={"replay": n_r, "eager": n_e})


def guard_rollback(root: str):
    """Phase 14: ``digits_h100.yaml`` guarded (``max_consecutive_skips``
    3), epoch 1's last 4 steps poisoned through ``$TPUDDP_FAULT``: a
    rollback to ``ckpt_0.npz`` and epoch 1 redone; against a run resumed
    from a copy of the same ``ckpt_0.npz``: the redone epoch's row and the
    final state equal."""
    settings, training = _fused_settings(SETTINGS_DIGITS, num_epochs=2, checkpoint_epoch=1,
                                         guard=True)
    run_dir, resume_dir = os.path.join(root, "rollback"), os.path.join(root, "resumed")
    poisoned = ",".join(f"nan@step={s}" for s in range(86, 90))  # epoch 1 is steps 45-89
    os.environ["TPUDDP_FAULT"] = poisoned
    faults.reload_faults()
    reset_counts()
    try:
        captured = {}

        def worker(rank, world_size, save_dir, optional_args):
            ddp, train_loader, test_loader, seed = build_training(rank, world_size, training, "cuda")
            history = run_training_loop(
                ddp, train_loader, test_loader, save_dir, num_epochs=2, checkpoint_epoch=1,
                base_seed=seed, log=lambda *_: None)
            captured[save_dir] = {k: v.detach().clone() for k, v in ddp.model.state_dict().items()}
            return history

        os.makedirs(run_dir)
        history = run_ddp_training(worker, 1, run_dir, {}, backend="cuda")
        launches = fused_adam.kernel.launches
    finally:
        del os.environ["TPUDDP_FAULT"]
        faults.reload_faults()
    os.makedirs(resume_dir)
    for name in ("ckpt_0.npz", "ckpt_0.npz.sha256"):
        shutil.copy(os.path.join(run_dir, name), resume_dir)
    training["auto_resume"] = True
    resumed = run_ddp_training(worker, 1, resume_dir, {}, backend="cuda")
    with open(os.path.join(run_dir, "history.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    events = [r for r in lines if r.get("event") == "rollback"]
    rows = [r for r in lines if "train_loss" in r]
    keys = ("train_loss", "test_loss", "test_accuracy")
    same = all(torch.equal(captured[run_dir][k], captured[resume_dir][k]) for k in captured[run_dir])
    checks = {
        "epochs 0, 1, 1": [r["epoch"] for r in rows] == [0, 1, 1],
        "one rollback event, epoch 1 to epoch 1": [(e["epoch"], e["resume_epoch"]) for e in events] == [(1, 1)],
        "the poisoned epoch: 4 skips, its loss null": (rows[1]["skipped_steps_epoch"], rows[1]["train_loss"])
        == (4, None),
        "the redone epoch's row is the resumed run's": [rows[2][k] for k in keys] == [resumed[-1][k] for k in keys],
        "the final state is the resumed run's": same,
        "one launch per update": launches == 3 * 45,
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 14 rollback failed {failed}: rows {rows}, events {events}, "
                         f"resumed {resumed}, launches {launches}")
    phase("14 rollback", f"digits_h100.yaml guarded, 2 epochs, {poisoned}: epochs "
          f"{[r['epoch'] for r in rows]}, rollback {events[0]['reason']!r} to epoch "
          f"{events[0]['resume_epoch']}; the redone epoch {[round(rows[2][k], 4) for k in keys]} equal "
          f"to the run resumed from ckpt_0.npz, final state bitwise; {launches} launches")
    return dict(epochs=[r["epoch"] for r in rows], event=events[0], launches=launches,
                redone=[rows[2][k] for k in keys])


def guard_phase(alexnet_shapes, bw, flops):
    """Phase 14: the numerical guard (``training.guard``)."""
    kernel = {w.moment_dtype: guard_kernel(w, alexnet_shapes, bw, flops)
              for w in fused_adam.kernels.values()}
    verdict = guard_verdict(alexnet_shapes, bw)
    torch.cuda.empty_cache()
    torch.manual_seed(0)
    init = AlexNet(num_classes=10).state_dict()
    bad = GUARD_K * (GUARD_CHUNKS - 1) + GUARD_BAD
    batches = _guard_batches(GUARD_K * GUARD_CHUNKS, 5, poison=bad)
    clean = _guard_batches(GUARD_K * 2, 6)
    chunks = [guard_chunk(hook, batches, clean, init) for hook in ("none", "bf16_ef")]
    managed = managed_guard(batches)
    root = tempfile.mkdtemp(prefix="tpuddp_torch_guard_")
    try:
        rollback = guard_rollback(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(kernel=kernel, verdict=verdict, chunks=chunks, managed=managed, rollback=rollback)


# ---------------------------------------------------------------- phase 15 --

RESNET_K, RESNET_CHUNKS = 8, 3
RESNET_GUARD_BAD = 3  # the last chunk's step 3 poisoned: nan@step=19
RESNET_TURNS = ("resnet50", "resnet50_s2d", "resnet50_s2d", "resnet50")


def _tables(n_leaves: int) -> int:
    return math.ceil(n_leaves / fused_adam.MAX_LEAVES)


def _resnet_model(init):
    """``(model, augment, generator, name)``: the settings file's
    ``resnet18_small`` (sync_bn) on the card holding the weights ``init``,
    and its 32 px train augment (flips) with the generator it draws from."""
    with torch.device("meta"):
        model = convert_sync_batchnorm(load_model("resnet18_small", 10))
    model.to_empty(device="cuda").load_state_dict(init)
    gen = torch.Generator().manual_seed(1)
    return model, make_train_augment(size=None, flip=True, generator=gen), gen, "resnet18_small"


def _resnet_ddp(init, replay: bool, **kwargs):
    """The native wrap of :func:`_resnet_model`."""
    model, augment, gen, _ = _resnet_model(init)
    ddp = DistributedDataParallel(model, Adam(model.parameters(), lr=1e-3), CrossEntropyLoss(),
                                  augment=augment, device="cuda", generator=gen, **kwargs)
    ddp._graph_replay = replay
    return ddp


def _resnet_state(ddp):
    """:func:`_ddp_state` and every BatchNorm buffer."""
    state = _ddp_state(ddp)
    state.update({f"buffer/{n}": b.clone() for n, b in ddp.model.named_buffers()})
    return state


def resnet_file(n_leaves: int):
    """15 (a): ``cifar10_resnet18_small_h100.yaml`` natively, an epoch one
    step per batch, 3 epochs at ``scan_steps: auto`` (one 16-step chunk an
    epoch: the eager warm-up, the capture, a replay) and 3 chunks of 8
    replayed against the same chunks run eagerly from one state."""
    tables = _tables(n_leaves)
    out = {}
    for label, overrides in (("scan_steps 1", {"scan_steps": 1}), ("scan_steps auto", {"num_epochs": 3})):
        history, wall_s, launches = native_run(SETTINGS_RESNET, overrides)
        steps = sum(len(r["step_ms"]) for r in history)
        rows = dict(fused_adam.kernel.table_rows)
        checks = {
            "16 train steps an epoch": all(len(r["step_ms"]) == 16 for r in history),
            f"{tables} float32-kernel launches per update": launches[fused_adam.kernel.symbol] == tables * steps,
            "finite losses": all(math.isfinite(r[k]) for r in history for k in ("train_loss", "test_loss")),
            "2048 train / 512 test samples": all(
                (r["train_samples"], r["test_samples"]) == (2048, 512) for r in history),
        }
        failed = [c for c, ok in checks.items() if not ok]
        if failed:
            raise SystemExit(f"chip_smoke: 15 resnet file, {label}, failed {failed}: launches {launches}, "
                             f"tables by rows {rows}, history {history}")
        last = history[-1]
        median = statistics.median(last["step_ms"][1:] if label == "scan_steps 1" else last["step_ms"])
        out[label] = dict(launches=launches[fused_adam.kernel.symbol], tables_by_rows=rows,
                          step_ms_median=median, epochs=[
                              {k: r[k] for k in ("train_loss", "test_loss", "test_accuracy")} for r in history],
                          wall_s=wall_s)
        phase("15 resnet file", f"cifar10_resnet18_small_h100.yaml (resnet18_small, sync_bn, 32 px, b128, "
              f"float32) {label}: {len(history)} epoch(s), {steps} steps, {launches} launches "
              f"({tables} per update; tables by rows {rows}), losses "
              + ", ".join(f"{r['train_loss']:.4f}/{r['test_loss']:.4f}" for r in history)
              + f"; step median {median:.3f} ms ({'steps 2-16' if label == 'scan_steps 1' else 'epoch 3, replayed'}"
              f", {128 * 1e3 / median:.0f} img/s); {wall_s:.1f} s")
    torch.manual_seed(0)
    init = load_model("resnet18_small", 10).state_dict()
    batches = _guard_batches(RESNET_K * RESNET_CHUNKS, 3)

    out["graph vs eager"] = native_chunk_pair(
        "resnet18_small@32 b128 sync_bn, flips", partial(_resnet_model, init), batches, RESNET_K,
        tables=tables, tag="15 resnet graph vs eager")
    return out


def resnet_guard(init, n_leaves: int):
    """15 (d): 3 guarded ``resnet18_small`` chunks of 8, the last with its
    step 3 poisoned, replayed (warm-up, capture, replay) and eagerly, the
    eager run cut around the poisoned step: the skipped update a bitwise
    no-op on parameters, moments and every BatchNorm buffer, each of its
    launch tables at verdict 0; replay bitwise eager; counters (1, 0)."""
    tables = _tables(n_leaves)
    bad = RESNET_K * (RESNET_CHUNKS - 1) + RESNET_GUARD_BAD
    batches = _guard_batches(RESNET_K * RESNET_CHUNKS, 5, poison=bad)
    runs, noop = {}, None
    for mode in ("eager", "replay"):
        gc.collect()
        torch.cuda.empty_cache()
        ddp = _resnet_ddp(init, mode == "replay", guard=True)
        torch.cuda.manual_seed(7)
        reset_counts()
        graphs.reset_stats()
        for c in range(RESNET_CHUNKS):
            chunk = batches[c * RESNET_K:(c + 1) * RESNET_K]
            if mode == "replay" or c < RESNET_CHUNKS - 1:
                ddp.train_step_many(chunk)
                continue
            ddp.train_step_many(chunk[:RESNET_GUARD_BAD])
            before, launched = _resnet_state(ddp), fused_adam.kernel.launches
            ddp.train_step_many(chunk[RESNET_GUARD_BAD:RESNET_GUARD_BAD + 1])
            after, launched = _resnet_state(ddp), fused_adam.kernel.launches - launched
            leaves = [n for n, _ in ddp.model.named_parameters()]
            same = {k: torch.equal(before[k], after[k]) for k in before if not k.startswith("grad/")}
            noop = {
                "parameters, moments and BatchNorm buffers bitwise": all(same.values()),
                f"{len(list(ddp.model.buffers()))} BatchNorm buffers held": all(
                    v for k, v in same.items() if k.startswith("buffer/")),
                f"table 1 (leaves 1-{fused_adam.MAX_LEAVES}) and table {tables} (leaves "
                f"{fused_adam.MAX_LEAVES * (tables - 1) + 1}-{len(leaves)}) at verdict 0": all(
                    same[f"param/{n}"] for n in leaves),
                f"{tables} launches for the skipped update": launched == tables,
                "counters (1, 1)": ddp.skip_counters() == (1, 1),
            }
            del before, after
            ddp.train_step_many(chunk[RESNET_GUARD_BAD + 1:])
        torch.cuda.synchronize()
        runs[mode] = (_resnet_state(ddp), ddp.skip_counters(), fused_adam.kernel.launches,
                      _kinds(graphs.stats))
        del ddp
    (eager, c_e, n_e, _), (replay, c_r, n_r, g_r) = runs["eager"], runs["replay"]
    diff = max(float((eager[k].double() - replay[k].double()).abs().max()) for k in eager)
    updates = RESNET_K * RESNET_CHUNKS
    checks = {
        **{f"the skipped update: {k}": ok for k, ok in noop.items()},
        "replay bitwise eager (parameters, last gradients, moments, buffers)": diff == 0.0,
        "counters (1, 0)": c_e == c_r == (1, 0),
        f"{tables} launches per update, the skipped one too": n_e == n_r == tables * updates,
        "1 capture, 2 replays": g_r == {"train": (1, RESNET_CHUNKS - 1)},
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 15 resnet guard failed {failed}: max|d|={diff}, counters {c_e} "
                         f"{c_r}, launches {n_e} {n_r}, graphs {g_r}, the skipped update {noop}")
    del runs, eager, replay
    torch.cuda.empty_cache()
    phase("15 resnet guard", f"resnet18_small@32 b128 sync_bn guarded, {RESNET_CHUNKS} chunks of {RESNET_K}, "
          f"nan@step={bad}: the skipped update {noop}; replay vs eager max |d| {diff:.3g} (bitwise), "
          f"counters {c_r}, launches replay {n_r} eager {n_e}, graphs {g_r}")
    return dict(max_abs_diff=diff, counters=list(c_r), launches={"replay": n_r, "eager": n_e},
                skipped_update=noop)


def resnet_overlap(init, n_leaves: int):
    """15 (e): ``resnet18_small`` with ``int8_ef`` at ``bucket_cap_mb: 5``
    (two segments), 3 chunks of 4 through the barrier step eagerly (the
    reference), the segmented step (``comm_overlap: true``) eagerly and
    replayed, and the barrier step replayed: max |d| 0 over parameters,
    gradients, moments, the residual and the BatchNorm buffers."""
    tables, k, chunks = _tables(n_leaves), 4, 3
    batches = _guard_batches(k * chunks, 4)
    states, launches, meta, counts = {}, {}, None, None
    for label, overlap, replay in (("barrier eager", False, False), ("segmented eager", True, False),
                                   ("segmented replay", True, True), ("barrier replay", False, True)):
        gc.collect()
        torch.cuda.empty_cache()
        ddp = _resnet_ddp(init, replay, comm_hook="int8_ef", bucket_cap_mb=5.0, comm_overlap=overlap)
        if overlap:
            meta = ddp.comm_overlap_meta
        torch.cuda.manual_seed(7)
        reset_counts()
        for c in range(chunks):
            ddp.train_step_many(batches[c * k:(c + 1) * k])
        torch.cuda.synchronize()
        launches[label] = fused_adam.kernel.launches
        states[label] = _resnet_state(ddp)
        if label == "segmented eager":
            counts = dict(ddp._overlap.counts)
        del ddp
    ref = states.pop("barrier eager")
    diff = {run: max(float((st[key].double() - ref[key].double()).abs().max()) for key in ref)
            for run, st in states.items()}
    updates = k * chunks
    checks = {
        "segmented: enabled, 2 segments": meta == {"enabled": True, "segments": 2, "reason": None},
        "every segment exchanged from inside the backward": counts == {"hook": 2 * updates, "join": 0},
        "max |d| = 0": all(v == 0.0 for v in diff.values()),
        f"{tables} launches per update": all(n == tables * updates for n in launches.values()),
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 15 resnet overlap failed {failed}: meta {meta}, counts {counts}, "
                         f"diff {diff}, launches {launches}")
    torch.cuda.empty_cache()
    phase("15 resnet overlap", f"resnet18_small@32 b128 sync_bn int8_ef bucket_cap_mb 5, {chunks} chunks of "
          f"{k}: comm_overlap_meta {meta}, segment exchanges {counts}; max |d| vs the eager barrier run "
          f"{diff} (bitwise); Adam launches {launches}")
    return dict(meta=meta, segment_exchanges=counts, max_abs_diff=diff, launches=launches)


def resnet50_turns():
    """15 (c): one epoch of the settings file at ``model: resnet50`` and
    ``resnet50_s2d``, 224 px, float32, one step per batch, in turns: step
    medians (steps 2-16), peak device memory, launches."""
    runs = {m: [] for m in RESNET_TURNS[:2]}
    for model in RESNET_TURNS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        history, wall_s, launches = native_run(
            SETTINGS_RESNET, {"model": model, "image_size": 224, "scan_steps": 1})
        steps = len(history[0]["step_ms"])
        n = launches[fused_adam.kernel.symbol]
        if steps != 16 or n != 4 * steps or not math.isfinite(history[0]["train_loss"]):
            raise SystemExit(f"chip_smoke: 15 resnet50 {model}: {steps} steps, {launches} launches "
                             f"(expected 4 per update), history {history}")
        runs[model].append(dict(step_ms_median=statistics.median(history[0]["step_ms"][1:]),
                                max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                                launches=n, train_loss=history[0]["train_loss"], wall_s=wall_s))
    medians = {m: statistics.median(r["step_ms_median"] for r in v) for m, v in runs.items()}
    phase("15 resnet50", "resnet50 and resnet50_s2d @224 b128 float32 (no TF32), one epoch each at scan_steps 1, "
          f"in turns {RESNET_TURNS}: step medians (steps 2-16) "
          + "; ".join(f"{m} " + ", ".join(f"{r['step_ms_median']:.2f}" for r in v) + " ms, peak "
                      + ", ".join(f"{r['max_memory_allocated_gb']:.2f}" for r in v) + " GB"
                      for m, v in runs.items())
          + f"; s2d/plain {medians['resnet50_s2d'] / medians['resnet50']:.3f}; 4 Adam launches per update")
    return dict(turns=list(RESNET_TURNS), runs=runs, medians=medians)


def adam_graph_ms(wrapper, shapes):
    """One Adam step of ``wrapper``'s kernel over ``shapes`` replayed from a
    CUDA graph, and (float32) ``torch.optim.Adam(fused=True,
    capturable=True)`` likewise, in turns (kernel, library, library,
    kernel): device ms without the host's enqueue, which over 161 leaves
    takes as long as the launches."""
    leaves = make_leaves(shapes, seed=1, moments=wrapper.moment_dtype)
    steps = step_counts(1, len(shapes))
    ps, gs, ms, vs = (list(x) for x in zip(*leaves))
    bcs = [fused_adam.bias_corrections(s, HP["betas"]) for s in steps]
    fns = {"kernel": partial(wrapper, ps, gs, ms, vs, bc1s=[b[0] for b in bcs],
                             bc2s=[b[1] for b in bcs], steps=steps,
                             leaves=leaf_indices(len(leaves)), weight_decay=0.0, **HP)}
    order = ("kernel", "kernel")
    if wrapper.moment_dtype == torch.float32:
        params = [torch.nn.Parameter(p.clone()) for p in ps]
        for prm, g in zip(params, gs):
            prm.grad = g.clone()
        fns["library"] = torch.optim.Adam(params, fused=True, capturable=True, **HP).step
        order = ("kernel", "library", "library", "kernel")
    runs = {k: [] for k in fns}
    for k in order:
        runs[k].append(graph_ms(fns[k]))
    del leaves, fns
    torch.cuda.empty_cache()
    return {k: min(v) for k, v in runs.items()}


def resnet_phase(bw, flops):
    """Phase 15: the ResNets (``configs/multihost.yaml``'s model on one
    card, and ResNet-50's 161-leaf Adam update in 4 launch tables)."""
    with torch.device("meta"):
        small_shapes = [tuple(p.shape) for p in load_model("resnet18_small", 10).parameters()]
        r50_shapes = [tuple(p.shape) for p in load_model("resnet50", 10).parameters()]
    file_runs = resnet_file(len(small_shapes))
    managed = managed_vs_native("resnet18_small", size=None, sync_bn=True, tag="15 resnet managed vs native")
    if managed["max_abs_dp"] != 0.0 or managed["launches"] != {"native": 6, "managed": 6}:
        raise SystemExit(f"chip_smoke: 15 resnet managed vs native: {managed}")
    r50 = resnet50_turns()
    kernels = {}
    for wrapper in fused_adam.kernels.values():
        err = compare(wrapper, [("ResNet-50", r50_shapes, "", 0.0)], r50_shapes, tag="15 resnet50 adam",
                      p_relative=True)
        torch.cuda.empty_cache()
        kernels[wrapper.moment_dtype] = {**time_kernel(wrapper, r50_shapes, bw, flops, label="ResNet-50",
                                                       tag="15 resnet50 adam"), "max_abs_err": err}
        torch.cuda.empty_cache()
        graphed = adam_graph_ms(wrapper, r50_shapes)
        kernels[wrapper.moment_dtype].update(graph_ms=graphed["kernel"],
                                             library_graph_ms=graphed.get("library"),
                                             launches_per_step=_tables(len(r50_shapes)))
        bound = kernels[wrapper.moment_dtype]["bound_ms"]
        phase("15 resnet50 adam", f"one ResNet-50 Adam step of {KERNEL_NAMES[wrapper.moment_dtype]} "
              f"replayed from a CUDA graph (4 launches, no host enqueue), best of two in turns: "
              f"kernel {graphed['kernel']:.4f} ms ({100 * bound / graphed['kernel']:.1f}% of the "
              f"{bound:.4f} ms bound)" + (f", torch.optim.Adam(fused=True, capturable=True) "
                                           f"{graphed['library']:.4f} ms" if "library" in graphed else ""))
    torch.manual_seed(0)
    init = load_model("resnet18_small", 10).state_dict()
    guard = resnet_guard(init, len(small_shapes))
    overlap = resnet_overlap(init, len(small_shapes))
    return dict(file=file_runs, managed_vs_native=managed, resnet50=r50, kernels=kernels, guard=guard,
                overlap=overlap, leaves={"resnet18_small": len(small_shapes), "resnet50": len(r50_shapes)})


VGG_K, VGG_CHUNKS = 4, 3
VGG11_SIZES = {"32 px (1 -> 7 pool)": None, "64 px (2 -> 7 pool)": 64}


def _vgg_init(name: str):
    """The registry VGG ``name``'s initial weights, drawn on the card from
    a seed."""
    torch.manual_seed(0)
    with torch.device("cuda"):
        return {k: v.clone() for k, v in load_model(name, 10).state_dict().items()}


def _vgg_runs(name: str, size, modes, batches, init):
    """``VGG_CHUNKS`` chunks of ``VGG_K`` native steps of ``name`` (flips,
    dropout, Adam) from the weights ``init``, one run per mode (``eager``:
    ``_graph_replay = False``; ``replay``: warm-up, capture, replay), each
    from the same dropout stream: its state (parameters, last gradients,
    moments), sums, float32-kernel launches, graph counts and each chunk's
    seconds."""
    runs = []
    for mode in modes:
        gc.collect()
        torch.cuda.empty_cache()
        with torch.device("meta"):
            model = load_model(name, 10)
        model.to_empty(device="cuda").load_state_dict(init)
        gen = torch.Generator().manual_seed(1)
        ddp = DistributedDataParallel(model, Adam(model.parameters(), lr=1e-3), CrossEntropyLoss(),
                                      augment=make_train_augment(size=size, flip=True, generator=gen),
                                      device="cuda", generator=gen)
        ddp._graph_replay = mode == "replay"
        torch.cuda.manual_seed(7)
        reset_counts()
        graphs.reset_stats()
        sums, seconds = None, []
        for c in range(VGG_CHUNKS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sums = ddp.train_step_many(batches[c * VGG_K:(c + 1) * VGG_K], sums)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        runs.append(dict(mode=mode, state=_ddp_state(ddp), sums=sums.clone(),
                         launches=fused_adam.kernel.launches, graphs=_kinds(graphs.stats), seconds=seconds))
        del ddp, model
    return runs


def _max_diff(a, b) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def vgg_chunk_checks(label: str, name: str, size, modes, seed: int):
    """16 (a, b): the chunk runs of ``modes`` from one state; every later
    run bitwise the first (parameters, last gradients, moments, sums), one
    Adam launch per update counted by the kernel, a replay run's 1
    capture and 2 replays. Returns the runs' numbers (the replay run's
    last chunk is a pure replay: its seconds over ``VGG_K`` is the
    replayed step)."""
    runs = _vgg_runs(name, size, modes, _guard_batches(VGG_K * VGG_CHUNKS, seed), _vgg_init(name))
    ref = runs[0]
    diffs = [max(_max_diff(ref["state"], r["state"]), float((ref["sums"] - r["sums"]).abs().max()))
             for r in runs[1:]]
    updates = VGG_K * VGG_CHUNKS
    checks = {
        "every run bitwise the first (parameters, last gradients, moments, sums)": all(d == 0.0 for d in diffs),
        "1 Adam launch per update, counted by the kernel": all(r["launches"] == updates for r in runs),
        "finite sums": all(bool(torch.isfinite(r["sums"]).all()) for r in runs),
        "replay: 1 capture, 2 replays": all(r["graphs"] == {"train": (1, VGG_CHUNKS - 1)}
                                             for r in runs if r["mode"] == "replay"),
    }
    failed = [c for c, ok in checks.items() if not ok]
    out = dict(modes=list(modes), max_abs_diff=diffs, launches=[r["launches"] for r in runs],
               chunk_s=[r["seconds"] for r in runs])
    if failed:
        raise SystemExit(f"chip_smoke: 16 {label} failed {failed}: {out}")
    replay = [r for r in runs if r["mode"] == "replay"]
    if replay:
        out["replayed_step_ms"] = replay[0]["seconds"][-1] * 1e3 / VGG_K
    phase("16 vgg chunks", f"{label}, {VGG_CHUNKS} chunks of {VGG_K} from one state with flips and dropout, "
          f"runs {'/'.join(modes)}: max |d| vs the first {diffs} (bitwise), Adam launches "
          f"{out['launches']}, chunk s " + "; ".join(", ".join(f"{t:.3f}" for t in r["seconds"]) for r in runs)
          + (f"; replayed step {out['replayed_step_ms']:.2f} ms" if replay else ""))
    del runs, ref
    torch.cuda.empty_cache()
    return out


def vgg16_file():
    """16 (a): ``cifar10_alexnet_h100.yaml`` at ``model: vgg16`` (224 px,
    b128, float32), one epoch one step per batch (16 steps): finite losses,
    one Adam launch per update, the step median (steps 2-16), peak memory."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    history, wall_s, launches = native_run(SETTINGS, {"model": "vgg16", "scan_steps": 1})
    row = history[0]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    checks = {
        "16 train steps": len(row["step_ms"]) == 16,
        "1 float32-kernel launch per update": launches[fused_adam.kernel.symbol] == 16
        and sum(launches.values()) == 16,
        "finite losses": all(math.isfinite(row[k]) for k in ("train_loss", "test_loss")),
        "2048 train / 512 test samples": (row["train_samples"], row["test_samples"]) == (2048, 512),
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 16 vgg16 file failed {failed}: launches {launches}, history {history}")
    median = statistics.median(row["step_ms"][1:])
    phase("16 vgg16 file", f"cifar10_alexnet_h100.yaml at model vgg16 (224 px, b128, float32, no TF32), one "
          f"epoch at scan_steps 1: {launches[fused_adam.kernel.symbol]} Adam launches, train_loss "
          f"{row['train_loss']:.4f} test_loss {row['test_loss']:.4f}; step median (steps 2-16) {median:.2f} ms "
          f"({128 * 1e3 / median:.0f} img/s), first {row['step_ms'][0]:.2f}; peak memory {peak_gb:.2f} GB; "
          f"wall {wall_s:.1f} s")
    return dict(step_ms_median=median, max_memory_allocated_gb=peak_gb, launches=launches[fused_adam.kernel.symbol],
                train_loss=row["train_loss"], test_loss=row["test_loss"], wall_s=wall_s)


def _params_of(path: str, prefix: str):
    with np.load(path) as data:
        return {k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)}


def pretrained_checks(root: str):
    """16 (c): a 1000-class torchvision-layout AlexNet written from a seed;
    before a step, the loaded model on the card holds the file's tensors
    bitwise but the head, which is 10x4096; one cut epoch of
    ``cifar10_alexnet_h100.yaml`` with ``pretrained_path`` through each
    entry point, the managed parameters bitwise the native ones; then
    1000-class ``vgg16`` and ``resnet18`` files load with their heads
    swapped."""
    torch.manual_seed(14)
    path = os.path.join(root, "alexnet_1000.pt")
    torch.save(AlexNet(num_classes=1000).state_dict(), path)
    file_sd = torch.load(path, weights_only=True)
    settings, training = training_for(SETTINGS)
    training.update(pretrained_path=path, checkpoint_epoch=1)
    model = pretrained_from_config(training).cuda()
    loaded = {k: v.cpu() for k, v in model.state_dict().items()}
    head = loaded["classifier.6.weight"].shape
    features_equal = all(torch.equal(loaded[k], v) for k, v in file_sd.items() if not k.startswith("classifier.6."))
    del model
    runs, launches = {}, {}
    for kind, worker in (("native", basic_ddp_training_loop), ("managed", basic_accelerate_training)):
        save_dir = os.path.join(root, kind)
        os.makedirs(save_dir)
        reset_counts()
        runs[kind] = run_ddp_training(partial(worker, training=training, device="cuda"), 1, save_dir,
                                      cfg_lib.optional_args_from(settings), backend="cuda")[0]
        torch.cuda.synchronize()
        launches[kind] = fused_adam.kernel.launches
    native = _params_of(os.path.join(root, "native", "ckpt_0.npz"), ".params")
    managed = _params_of(os.path.join(root, "managed", "state_0.npz"), "['params']")
    diff = max(float(np.abs(native[k].astype(np.float64) - managed[k]).max()) for k in native)
    swapped = {}
    for name, model in (("vgg16", load_model("vgg16", 1000)), ("resnet18", load_model("resnet18", 1000))):
        donor = os.path.join(root, f"{name}_1000.pt")
        torch.save(model.state_dict(), donor)
        got = pretrained_from_config(dict(training, model=name, pretrained_path=donor)).state_dict()
        head_key = "fc" if name.startswith("resnet") else "classifier.6"
        same = all(torch.equal(got[k], v) for k, v in model.state_dict().items() if not k.startswith(head_key + "."))
        swapped[name] = (tuple(got[f"{head_key}.weight"].shape), same)
        del model, got
        os.remove(donor)
    checks = {
        "features bitwise the file before the first step": features_equal,
        "head 10x4096": tuple(head) == (10, 4096),
        "16 Adam launches per epoch on each path": launches == {"native": 16, "managed": 16},
        "finite losses": all(math.isfinite(r[k]) for r in runs.values() for k in ("train_loss", "test_loss")),
        "managed parameters bitwise the native ones": native.keys() == managed.keys() and diff == 0.0,
        "vgg16 and resnet18 heads swapped, the rest the files'": swapped == {
            "vgg16": ((10, 4096), True), "resnet18": ((10, 512), True)},
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 16 pretrained failed {failed}: runs {runs}, launches {launches}, "
                         f"max|d| {diff}, swapped {swapped}")
    phase("16 pretrained", f"1000-class AlexNet file from a seed: features bitwise the file on the card, head "
          f"{tuple(head)}; one epoch of cifar10_alexnet_h100.yaml with pretrained_path: native "
          f"{runs['native']['train_loss']:.4f}/{runs['native']['test_loss']:.4f}, managed "
          f"{runs['managed']['train_loss']:.4f}/{runs['managed']['test_loss']:.4f}, parameters max |d| "
          f"{diff:.3g} (bitwise), Adam launches {launches}; vgg16 and resnet18 files: heads {swapped}")
    return dict(head=list(head), losses={k: [r["train_loss"], r["test_loss"]] for k, r in runs.items()},
                max_abs_dp=diff, launches=launches, swapped={k: list(v[0]) for k, v in swapped.items()})


def vgg_phase(bw, flops):
    """Phase 16: the VGGs and the pretrained fine-tune."""
    with torch.device("meta"):
        shapes = [tuple(p.shape) for p in load_model("vgg16", 10).parameters()]
    out = {"vgg16_file": vgg16_file()}
    out["vgg16_chunks"] = vgg_chunk_checks("vgg16@224 b128 float32", "vgg16", 224, ("eager", "replay"), 11)
    out["vgg11_chunks"] = {label: vgg_chunk_checks(f"vgg11@{label} b128 float32", "vgg11", size,
                                                   ("eager", "eager", "replay"), 12)
                           for label, size in VGG11_SIZES.items()}
    managed = managed_vs_native("vgg11", size=None, tag="16 vgg managed vs native")
    if managed["max_abs_dp"] != 0.0 or managed["launches"] != {"native": 3, "managed": 3}:
        raise SystemExit(f"chip_smoke: 16 vgg managed vs native: {managed}")
    out["vgg11_managed_vs_native"] = managed
    root = tempfile.mkdtemp(prefix="tpuddp_torch_pretrained_")
    try:
        out["pretrained"] = pretrained_checks(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    kernels = {}
    for wrapper in fused_adam.kernels.values():
        err = compare(wrapper, [("VGG-16", shapes, "", 0.0)], shapes, tag="16 vgg16 adam", p_relative=True)
        torch.cuda.empty_cache()
        kernels[wrapper.moment_dtype] = {**time_kernel(wrapper, shapes, bw, flops, label="VGG-16",
                                                       tag="16 vgg16 adam"), "max_abs_err": err,
                                         "launches_per_step": _tables(len(shapes))}
        torch.cuda.empty_cache()
    out["kernels"] = kernels
    out["leaves"] = len(shapes)
    return out


# ---------------------------------------------------------------- phase 17 --
# configs/multihost.yaml whole: two "hosts" (two launcher processes, each one
# rank on this card) meet at a coordinator through the rendezvous, over Gloo
# (NCCL refuses two ranks on one GPU), at global world 2 = 2 hosts x 1 local.
SETTINGS_MULTIHOST = os.path.join(CONFIGS, "multihost_h100.yaml")
MULTIHOST_TOPOLOGIES = {
    "flat": {},
    "hierarchical none": {"comm_topology": "hierarchical"},
    "hierarchical bf16_ef": {"comm_topology": "hierarchical", "comm_hook": "bf16_ef"},
}
# flat against hierarchical in turns, bf16_ef between them
MULTIHOST_TURNS = ("flat", "hierarchical none", "hierarchical bf16_ef", "hierarchical none", "flat")
MULTIHOST_S = 600
# each host process: every turn in order, each the native entry point's
# main() as `python -m tpuddp_torch.train_native` runs it, the Adam-kernel
# launch counts set to 0 just before it and printed just after. One process
# per host for all turns: a process start (~8 s to reach the card) is most
# of a turn's time.
HOST_SCRIPT = (
    "import json, sys\n"
    "from tpuddp_torch import train_native\n"
    "from tpuddp_torch.ops import fused_adam\n"
    "for path in sys.argv[1:]:\n"
    "    for k in fused_adam.kernels.values():\n"
    "        k.reset_launches()\n"
    "    train_native.main(['--settings_file', path])\n"
    "    print('LAUNCHES ' + json.dumps({k.symbol: k.launches for k in fused_adam.kernels.values()}),\n"
    "          flush=True)\n"
)


def _free_ports(n: int):
    """``n`` distinct ports free on 127.0.0.1 (all bound at once, then
    released)."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def multihost_runs(root: str):
    """Every turn of :data:`MULTIHOST_TURNS` at world 2, ``multihost_h100.yaml``
    cut to one synthetic epoch, ``scan_steps: 1``, seed 0: two host
    processes (``$TPUDDP_PROCESS_ID`` 0 and 1), each turn at its own
    coordinator port and, per host, its own ``out_dir``. Returns per turn
    each host's stdout, ``out_dir`` and launches, and the wall seconds."""
    base = cfg_lib.load_settings(SETTINGS_MULTIHOST)
    ports = _free_ports(len(MULTIHOST_TURNS))
    paths, runs = ([], []), []
    for turn, (label, port) in enumerate(zip(MULTIHOST_TURNS, ports)):
        settings = json.loads(json.dumps(base))
        # the file has no seed (a fresh one per run): runs compared bitwise need one
        settings["training"].update(num_epochs=1, dataset="synthetic", synthetic_n=[2048, 512],
                                    scan_steps=1, seed=0, **MULTIHOST_TOPOLOGIES[label])
        settings["local"]["rendezvous"]["coordinator_address"] = f"127.0.0.1:{port}"
        dirs = []
        for pid in (0, 1):
            name = f"turn{turn}_{label.replace(' ', '_')}_host{pid}"
            d = os.path.join(root, name)
            os.makedirs(d)
            with open(os.path.join(root, name + ".yaml"), "w") as f:
                json.dump(dict(settings, out_dir=d), f)  # JSON is YAML
            paths[pid].append(os.path.join(root, name + ".yaml"))
            dirs.append(d)
        runs.append(dict(label=label, dirs=dirs))
    procs = []
    t0 = time.perf_counter()
    for pid in (0, 1):
        env = dict(os.environ, TPUDDP_BACKEND="gloo", TPUDDP_PROCESS_ID=str(pid),
                   TPUDDP_WORLD_SIZE="2", PYTHONPATH=ROOT)
        for var in ("TPUDDP_COORDINATOR", "TPUDDP_NUM_PROCESSES"):
            env.pop(var, None)
        procs.append(subprocess.Popen([sys.executable, "-c", HOST_SCRIPT, *paths[pid]], cwd=ROOT,
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MULTIHOST_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall_s = time.perf_counter() - t0
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise SystemExit(f"chip_smoke: 17 multihost: host {pid} exited {p.returncode}:\n"
                             f"{out[-3000:]}\n{err[-5000:]}")
    for pid, (out, _) in enumerate(outs):
        # each turn's output ends at its LAUNCHES line
        parts = out.split("LAUNCHES ")
        if len(parts) != len(runs) + 1:
            raise SystemExit(f"chip_smoke: 17 multihost: host {pid} ran {len(parts) - 1} of "
                             f"{len(runs)} turns:\n{out[-3000:]}")
        # parts[0]: turn 0's lines; parts[i]: turn i-1's counts, then turn i's lines
        for i, run in enumerate(runs):
            run.setdefault("launches", []).append(json.loads(parts[i + 1].partition("\n")[0]))
            run.setdefault("stdout", []).append(parts[0] if i == 0 else parts[i].partition("\n")[2])
    return runs, wall_s


def _multihost_checks(run):
    """The run's own checks: both ranks at world 2, 2 hosts x 1 local;
    host 0 alone writes; the Adam kernel's launches per update."""
    label, (out0, out1), (d0, d1) = run["label"], run["stdout"], run["dirs"]
    history = [json.loads(l) for l in open(os.path.join(d0, "history.jsonl"))]
    updates = sum(len(r["step_ms"]) for r in history)
    tables = _tables(62)  # resnet18_small's 62 leaves
    f32 = fused_adam.kernel.symbol
    checks = {
        "both ranks at world 2, 2 hosts x 1 local": all(
            f"global rank {pid} of a 2-process world, host {pid} of 2, local rank 0 of 1." in out
            for pid, out in enumerate((out0, out1))),
        "host 0 alone writes epoch lines": (
            sum(l.startswith("Epoch 1/1, ") for l in out0.splitlines()) == 1
            and not any(l.startswith("Epoch ") for l in out1.splitlines())),
        "host 0 alone writes checkpoints": (
            os.path.exists(os.path.join(d0, "ckpt_0.npz"))
            and not any(n.endswith(".npz") or n.endswith(".jsonl") for n in os.listdir(d1))),
        "8 updates of 2x128 rows": updates == 8 and history[0]["train_samples"] == 2048,
        f"{tables} Adam launches per update in each process": all(
            n[f32] == tables * updates and sum(n.values()) == n[f32] for n in run["launches"]),
        "finite losses": all(math.isfinite(history[0][k]) for k in ("train_loss", "test_loss")),
    }
    if label != "flat":
        checks["the split logged by both ranks"] = all(
            f"comm_topology hierarchical on process {pid}: 2 hosts x 1 local (2-process world)." in out
            for pid, out in enumerate((out0, out1)))
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 17 multihost {label}: failed {failed}; launches "
                         f"{run['launches']}; host 0:\n{out0[-2000:]}\nhost 1:\n{out1[-2000:]}")
    return history[0]


def _file_diff(a, b) -> float:
    """Max |a - b| over two checkpoint files' state arrays (parameters,
    BatchNorm buffers, moments, residual; not the ``__``-prefixed records),
    inf where the keys, shapes or a non-float array differ."""
    a, b = ({k: v for k, v in f.items() if not k.startswith("__")} for f in (a, b))
    if sorted(a) != sorted(b):
        return math.inf
    out = 0.0
    for k in a:
        if a[k].shape != b[k].shape:
            return math.inf
        if a[k].dtype.kind == "f":
            d = np.abs(a[k].astype(np.float64) - b[k].astype(np.float64))
            out = max(out, float(d.max()) if d.size else 0.0)
        elif not np.array_equal(a[k], b[k]):
            return math.inf
    return out


def multihost_bytes():
    """AlexNet's counted bytes of one reduction at world 8 (2 x 4) and 16
    (2 x 8), per hook, flat and hierarchical (intra- and inter-host)."""
    with torch.device("meta"):
        sizes = jax_sizes("alexnet", AlexNet(num_classes=10))
    out = {}
    for world, local in ((8, 4), (16, 8)):
        for hook in comm.COMM_HOOKS:
            flat = comm.comm_bytes_breakdown(sizes, world, hook)
            hier = comm.comm_bytes_breakdown(sizes, world, hook, "hierarchical", local_size=local)
            out[f"world {world} = 2 x {local} {hook}"] = {
                "flat_inter_host": flat["inter_host"], "hierarchical_intra_host": hier["intra_host"],
                "hierarchical_inter_host": hier["inter_host"]}
            phase("17 bytes", f"AlexNet, world {world} = 2 hosts x {local}, {hook}: flat "
                  f"{flat['inter_host']:,} B inter-host; hierarchical {hier['intra_host']:,} B "
                  f"intra-host + {hier['inter_host']:,} B inter-host "
                  f"({hier['inter_host'] / flat['inter_host']:.4f} of flat's)")
    return out


def multihost_phase():
    """Phase 17: configs/multihost.yaml whole, at world 2 on this card."""
    root = tempfile.mkdtemp(prefix="tpuddp_torch_multihost_")
    runs = []
    try:
        turns, wall_s = multihost_runs(root)
        for run in turns:
            row = _multihost_checks(run)
            file = _arrays(os.path.join(run["dirs"][0], "ckpt_0.npz"))
            runs.append((run, row, file))
            median = statistics.median(row["step_ms"][1:])
            phase("17 multihost", f"multihost_h100.yaml (resnet18_small sync_bn 32 px b128 a rank), world "
                  f"2 = 2 hosts x 1 local through the rendezvous, Gloo through the host, two ranks on "
                  f"one card, {run['label']}: losses {row['train_loss']:.4f}/{row['test_loss']:.4f}, "
                  f"{run['launches'][0][fused_adam.kernel.symbol]} + "
                  f"{run['launches'][1][fused_adam.kernel.symbol]} launches, step median (steps 2-8) "
                  f"{median:.2f} ms; epoch {row['epoch_time_s']:.1f} s")
        by = {}
        for run, row, file in runs:
            by.setdefault(run["label"], []).append((row, file))
        flat, none, bf16 = (by[k][0] for k in MULTIHOST_TOPOLOGIES)
        # hierarchical none re-brackets a sum of two values: bitwise flat
        # (parameters, BatchNorm buffers, moments); every repeated run
        # bitwise its first
        pairs = [("hierarchical none vs flat", none[1], flat[1])] + [
            (f"{k} repeated", runs_[i][1], runs_[0][1]) for k, runs_ in by.items()
            for i in range(1, len(runs_))]
        diffs = {name: _file_diff(a, b) for name, a, b in pairs}
        residual = bf16[1][".comm_state"]
        tol = {k: comm.loss_parity_tol("bf16_ef", flat[0][k]) for k in ("train_loss", "test_loss")}
        checks = {
            "hierarchical none bitwise flat": diffs["hierarchical none vs flat"] == 0.0,
            "repeated runs bitwise": all(v == 0.0 for k, v in diffs.items() if k.endswith("repeated")),
            "bf16_ef within loss_parity_tol of flat": all(
                abs(bf16[0][k] - flat[0][k]) <= tol[k] for k in tol),
            "bf16_ef residual finite and not all zero": bool(np.isfinite(residual).all()
                                                             and np.any(residual != 0)),
        }
        failed = [c for c, ok in checks.items() if not ok]
        if failed:
            raise SystemExit(f"chip_smoke: 17 multihost: failed {failed}: diffs {diffs}, tol {tol}, "
                             f"losses flat {flat[0]['train_loss']}/{flat[0]['test_loss']} bf16_ef "
                             f"{bf16[0]['train_loss']}/{bf16[0]['test_loss']}")
        medians = {f"{run['label']} turn {i}": statistics.median(row["step_ms"][1:])
                   for i, (run, row, _) in enumerate(runs)}
        phase("17 multihost", "Gloo through the host, two ranks on one card (not an NCCL measurement): "
              "step medians in turns " + ", ".join(f"{k} {v:.2f} ms" for k, v in medians.items())
              + f"; max |d| {diffs}; bf16_ef losses {bf16[0]['train_loss']:.4f}/{bf16[0]['test_loss']:.4f} "
              f"vs flat {flat[0]['train_loss']:.4f}/{flat[0]['test_loss']:.4f} (bounds "
              f"{tol['train_loss']:.3f}/{tol['test_loss']:.3f}), residual max |r| "
              f"{float(np.abs(residual).max()):.3g}; {len(runs)} turns in {wall_s:.1f} s (two host "
              "processes, each running every turn)")
        out = {
            "turns": list(MULTIHOST_TURNS),
            "step_ms_medians_gloo_two_ranks_one_card": medians,
            "max_abs_diff": diffs,
            "losses": {run["label"]: [row["train_loss"], row["test_loss"]] for run, row, _ in runs},
            "bytes_per_update": {run["label"]: {k: row[k] for k in (
                "grad_comm_bytes_per_update", "grad_comm_bytes_intra_host", "grad_comm_bytes_inter_host")}
                for run, row, _ in runs},
            "launches": {f"native multihost {run['label']} turn {i} host {pid} (phase 17)":
                         run["launches"][pid][fused_adam.kernel.symbol]
                         for i, (run, _, _) in enumerate(runs) for pid in (0, 1)},
            "epoch_s": [row["epoch_time_s"] for _, row, _ in runs],
            "wall_s": wall_s,
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["alexnet_bytes"] = multihost_bytes()
    return out


def main() -> None:
    set_numerics()  # the entry points' numerics, for the pairs built here too
    name = torch.cuda.get_device_name(0)
    card = card_line()
    phase("1 device", f"{name}; nvidia-smi: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible")
    bw, flops = peaks_for(name)

    t0 = time.perf_counter()
    for k in fused_adam.kernels.values():
        k.load()
    build_s = time.perf_counter() - t0
    ptxas = " | ".join(
        line.strip() for line in fused_adam.library.build_log.splitlines()
        if "registers" in line or "spill" in line or "Compiling entry" in line
    )
    phase("2 build", f"fused_adam.cu (float32 and bf16 moments) built and loaded in "
          f"{build_s:.2f} s; ptxas: {ptxas}")
    t0 = time.perf_counter()
    _native.load()
    phase("2 build", f"gather.cpp ({' '.join(_native.CXX_FLAGS)}) built and loaded in "
          f"{time.perf_counter() - t0:.2f} s: {_native.library.path.name}")

    with torch.device("meta"):
        alexnet_shapes = [tuple(t.shape) for t in AlexNet(num_classes=10).parameters()]
    f32, bf16 = fused_adam.kernel, fused_adam.kernels[torch.bfloat16]
    cases = compare_cases(alexnet_shapes)
    err_f32 = compare(f32, cases, alexnet_shapes)
    err_bf16 = compare(bf16, cases, alexnet_shapes)
    torch.cuda.empty_cache()
    t_f32 = time_kernel(f32, alexnet_shapes, bw, flops)
    torch.cuda.empty_cache()
    t_bf16 = time_kernel(bf16, alexnet_shapes, bw, flops)
    torch.cuda.empty_cache()

    launches_f32, steps, steady_f32 = alexnet_epoch(
        "AlexNet@224 b128 float32", SETTINGS, f32)
    launches_bf16, steps_bf16, steady_bf16 = alexnet_epoch(
        "AlexNet@224 b128 bf16 compute, bf16 moments", SETTINGS_BF16, bf16)
    phase("4 bf16 vs float32", f"step median {steady_bf16:.2f} ms (bf16) vs {steady_f32:.2f} ms "
          f"(float32), ratio {steady_bf16 / steady_f32:.3f}")
    launches_toy = toy_cnn_epoch()

    launches_managed, steady_managed = managed_epoch("AlexNet@224 b128 float32", 1)
    phase("5 managed vs native", f"step median {steady_managed:.2f} ms (managed, one step per batch) vs "
          f"{steady_f32:.2f} ms (native, a replayed 16-step chunk), ratio {steady_managed / steady_f32:.3f}")
    launches_accum, _ = managed_epoch("AlexNet@224 b128 float32, gradient_accumulation_steps 2", 2)
    managed_vs_native()

    ab_f32 = pipeline_turns("AlexNet@224 b128 float32", SETTINGS, f32, True)
    ab_bf16 = pipeline_turns("AlexNet@224 b128 bf16 compute, bf16 moments", SETTINGS_BF16, bf16, False)
    ab_toy = pipeline_turns("toy_cnn@32 b128 sync_bn", SETTINGS_TOY, f32, False)
    gather_turns()

    root = tempfile.mkdtemp(prefix="tpuddp_torch_resume_")
    try:
        resume_native = resume_check("native", root)
        resume_managed = resume_check("managed", root)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    steps_8 = optimizer_steps(alexnet_shapes, bw)
    torch.cuda.empty_cache()
    epochs_8 = {name: optimizer_epoch(name, steady_f32) for name in OPTIMIZERS}
    lamb_accum = dict(optimizer="lamb", clip_grad_norm=1.0, **OPT_HP)
    launches_lamb, steady_lamb = managed_epoch(
        f"AlexNet@224 b128 float32, {lamb_accum}, gradient_accumulation_steps 2", 2, lamb_accum,
        tag="8 managed lamb")
    root = tempfile.mkdtemp(prefix="tpuddp_torch_resume_")
    try:
        resume_lars = resume_check("native", root, dict(optimizer="lars", **OPT_HP), tag="8 resume lars")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches_digits = digits_native()
    phase_8 = {f"native {n}": launches for n, (launches, _) in epochs_8.items()}
    phase_8.update({"managed lamb accum 2": launches_lamb, "native resumed lars": resume_lars})

    pairs = graph_pairs()
    root = tempfile.mkdtemp(prefix="tpuddp_torch_fused_")
    try:
        turns = fused_turns(root)
        resume_fused = fused_resume(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches_alex8, medians_alex8, capture_alex8 = fused_alexnet(steady_managed)
    t10 = time.perf_counter()
    native_chunk_pairs, native_eval_pairs = native_pairs()
    digits_10 = native_digits_turns()
    alexnet_10 = native_alexnet_turns()
    eval_10 = managed_eval_groups()
    phase_10_s = time.perf_counter() - t10
    t11 = time.perf_counter()
    launches_fast, fast_history = fast_file()
    fast_pair = fast_chunk_pair()
    torch.cuda.empty_cache()
    err_flat = {wrapper.moment_dtype: flat_compare(wrapper, sum(math.prod(sh) for sh in alexnet_shapes))
                for wrapper in (f32, bf16)}
    t_flat = {wrapper.moment_dtype: flat_time(wrapper, alexnet_shapes, bw, flops) for wrapper in (f32, bf16)}
    zero1_pairs = zero1_vs_replicated()
    stem = stem_turns(fast_history)
    phase_11_s = time.perf_counter() - t11
    t12 = time.perf_counter()
    hooks_12 = hooks_vs_plain()
    torch.cuda.empty_cache()
    native_12 = native_hooks()
    chunks_12 = hooked_chunk_pairs()
    managed_12 = managed_hooks()
    zero1_12 = zero1_hooks()
    root = tempfile.mkdtemp(prefix="tpuddp_torch_hooks_")
    try:
        resume_12 = {kind: hooked_resume(kind, root) for kind in ("native", "managed")}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase_12_s = time.perf_counter() - t12
    t13 = time.perf_counter()
    overlap_13 = overlap_phase()
    phase_13_s = time.perf_counter() - t13
    t14 = time.perf_counter()
    guard_14 = guard_phase(alexnet_shapes, bw, flops)
    phase_14_s = time.perf_counter() - t14
    t15 = time.perf_counter()
    resnet_15 = resnet_phase(bw, flops)
    phase_15_s = time.perf_counter() - t15
    t16 = time.perf_counter()
    vgg_16 = vgg_phase(bw, flops)
    phase_16_s = time.perf_counter() - t16
    t17 = time.perf_counter()
    multihost_17 = multihost_phase()
    phase_17_s = time.perf_counter() - t17
    f32_sym, bf16_sym = fused_adam.kernel.symbol, fused_adam.kernels[torch.bfloat16].symbol
    native_pair_launches = {f"native graph vs eager {p['label']} ({m})": p[f"launches_{m}"]
                            for p in native_chunk_pairs for m in ("replay", "eager")}
    phase_10 = {
        **{k: n[f32_sym] for k, n in native_pair_launches.items()},
        **{f"native digits {m}": n for m, n in digits_10["launches"].items()},
        **{f"native AlexNet {m}": n for m, n in alexnet_10["launches"].items()},
        **{f"managed eval groups {m}": n for m, n in eval_10["launches"].items()},
    }
    phase_10_bf16 = {k: n[bf16_sym] for k, n in native_pair_launches.items()}
    pair_launches = {f"graph vs eager {p['label']} ({m})": p[f"launches_{m}"] for p in pairs
                     for m in ("replay", "eager")}
    phase_9 = {
        **{k: n[f32_sym] for k, n in pair_launches.items()},
        **{f"managed fused digits {m}": n for m, n in turns["launches"].items()},
        "managed fused digits resumed": resume_fused,
        **{f"managed AlexNet {'depth 1' if m == 'depth 1' else 'depth 8 ' + m}": n
           for m, n in launches_alex8.items()},
    }
    phase_9_bf16 = {k: n[bf16_sym] for k, n in pair_launches.items()}
    print(json.dumps({"fused": {
        "graph_vs_eager": pairs,
        "managed_fused_h100": {k: turns[k] for k in (
            "medians", "rows_equal", "captures", "replays", "capture_s", "test_accuracy")},
        "alexnet_depth_8": {"turns": list(FUSED_TURNS), "epoch_2_step_ms": medians_alex8,
                            "phase_5_unfused_step_ms_median": steady_managed, "capture_s": capture_alex8},
    }}))
    print(json.dumps({"scan": {
        "native_graph_vs_eager": native_chunk_pairs + native_eval_pairs,
        "native_digits": digits_10, "native_alexnet_3_epochs": alexnet_10,
        "managed_eval_groups": eval_10, "phase_10_s": phase_10_s,
    }}))
    print(json.dumps({"zero1": {
        "fast_file": {"launches": launches_fast, "epochs": [
            {k: r[k] for k in ("train_loss", "test_loss", "test_accuracy")} for r in fast_history],
            "epoch_3_step_ms_median": statistics.median(fast_history[2]["step_ms"])},
        "fast_chunks_graph_vs_eager": fast_pair,
        "flat_shard": {KERNEL_NAMES[d]: {**t_flat[d], "max_abs_err": err_flat[d]} for d in t_flat},
        "zero1_vs_replicated": zero1_pairs, "stem": stem, "phase_11_s": phase_11_s,
    }}))
    print(json.dumps({"comm_hooks": {
        "round_trips_and_agreement": hooks_12, "native_alexnet_3_epochs": native_12,
        "phase_4_float32_step_ms_median": steady_f32, "graph_vs_eager": chunks_12,
        "managed_int8_ef_graph_vs_eager": managed_12, "zero1_bf16_ef": zero1_12,
        "bytes_per_update_alexnet": hook_bytes(), "phase_12_s": phase_12_s,
    }}))
    print(json.dumps({"overlap": {**overlap_13, "phase_13_s": phase_13_s}}))
    print(json.dumps({"guard": {
        "kernel": {KERNEL_NAMES[d]: v for d, v in guard_14["kernel"].items()},
        **{k: guard_14[k] for k in ("verdict", "chunks", "managed", "rollback")},
        "phase_14_s": phase_14_s,
    }}))
    print(json.dumps({"resnet": {
        **{k: resnet_15[k] for k in ("file", "managed_vs_native", "resnet50", "guard", "overlap", "leaves")},
        "adam_resnet50": {KERNEL_NAMES[d]: v for d, v in resnet_15["kernels"].items()},
        "phase_15_s": phase_15_s,
    }}))
    print(json.dumps({"vgg": {
        **{k: vgg_16[k] for k in ("vgg16_file", "vgg16_chunks", "vgg11_chunks", "vgg11_managed_vs_native",
                                  "pretrained", "leaves")},
        "adam_vgg16": {KERNEL_NAMES[d]: v for d, v in vgg_16["kernels"].items()},
        "phase_16_s": phase_16_s,
    }}))
    print(json.dumps({"multihost": {
        **{k: v for k, v in multihost_17.items() if k != "launches"}, "phase_17_s": phase_17_s,
    }}))
    print(json.dumps({"optimizers": [
        {"name": n, **steps_8[n], "native_step_ms_median": epochs_8[n][1],
         "adam_f32_step_ms_median": steady_f32, "launches_by_path": {f"native {n}": epochs_8[n][0]}}
        for n in OPTIMIZERS
    ] + [{"name": "lamb managed accum 2", "managed_step_ms_median": steady_lamb,
          "adam_f32_managed_step_ms_median": steady_managed},
         {"name": "clip_grad_norm_", **steps_8["clip"]}]}))

    phase_11 = {"native ZeRO-1 fast file": launches_fast,
                **{f"native ZeRO-1 fast chunks ({m})": fast_pair[f"launches_{m}"][bf16_sym]
                   for m in ("replay", "eager")},
                **{f"native ZeRO-1 stem turns {m}": n for m, n in stem["launches"].items()}}
    phase_11_f32 = {f"{k} (phase 11)": n for k, n in zero1_pairs["launches"].items()}
    phase_12 = {
        **{f"native comm_hook {h}": native_12[h]["launches"] for h in HOOKS},
        **{f"native graph vs eager {p['label']} ({m})": p[f"launches_{m}"][f32_sym]
           for p in chunks_12 for m in ("replay", "eager")},
        **{f"managed int8_ef graph vs eager ({m})": managed_12[f"launches_{m}"][f32_sym]
           for m in ("replay", "eager")},
        **{f"{k} bf16_ef (phase 12)": n for k, n in zero1_12["vs_replicated"]["launches"].items()},
        **{f"{k} digits int8_ef resumed": n for k, n in resume_12.items()},
    }
    phase_12_bf16 = {"native ZeRO-1 fast file bf16_ef": zero1_12["launches"]}
    phase_13 = {f"native AlexNet {p['hook']} A={p['accum']} {run} (phase 13)": n
                for p in overlap_13["pairs"] for run, n in p["launches"].items()}
    phase_14 = {
        **{f"native AlexNet guarded {c['hook']} {run} (phase 14)": n
           for c in guard_14["chunks"] for run, n in c["launches"].items()},
        **{f"managed AlexNet guarded {run} (phase 14)": n
           for run, n in guard_14["managed"]["launches"].items()},
        "native digits guarded rollback (phase 14)": guard_14["rollback"]["launches"],
    }
    phase_15 = {
        **{f"native resnet18_small file {k} (phase 15)": v["launches"]
           for k, v in resnet_15["file"].items() if k.startswith("scan_steps")},
        **{f"native resnet18_small graph vs eager ({m}) (phase 15)":
           resnet_15["file"]["graph vs eager"][f"launches_{m}"][f32_sym] for m in ("replay", "eager")},
        **{f"{k} resnet18_small (phase 15)": n
           for k, n in resnet_15["managed_vs_native"]["launches"].items()},
        **{f"native {m} turn {i} (phase 15)": r["launches"]
           for m, runs in resnet_15["resnet50"]["runs"].items() for i, r in enumerate(runs)},
        **{f"native resnet18_small guarded {m} (phase 15)": n
           for m, n in resnet_15["guard"]["launches"].items()},
        **{f"native resnet18_small int8_ef {m} (phase 15)": n
           for m, n in resnet_15["overlap"]["launches"].items()},
    }
    phase_16 = {
        "native vgg16 file (phase 16)": vgg_16["vgg16_file"]["launches"],
        **{f"native vgg16 chunks {m} (phase 16)": n
           for m, n in zip(vgg_16["vgg16_chunks"]["modes"], vgg_16["vgg16_chunks"]["launches"])},
        **{f"native vgg11 {label} chunks {m} {i} (phase 16)": n
           for label, c in vgg_16["vgg11_chunks"].items()
           for i, (m, n) in enumerate(zip(c["modes"], c["launches"]))},
        **{f"{k} vgg11 (phase 16)": n for k, n in vgg_16["vgg11_managed_vs_native"]["launches"].items()},
        **{f"{k} pretrained AlexNet (phase 16)": n for k, n in vgg_16["pretrained"]["launches"].items()},
    }
    phase_17 = multihost_17["launches"]
    by_path = {"native": launches_f32, "toy_cnn sync_bn": launches_toy,
               "managed": launches_managed, "managed accum 2": launches_accum,
               **{f"native pipeline {k}": n for k, n in ab_f32.items()},
               **{f"toy_cnn pipeline {k}": n for k, n in ab_toy.items()},
               "native resumed": resume_native, "managed resumed": resume_managed, **phase_8,
               "native digits": launches_digits, **phase_9, **phase_10, **phase_11_f32, **phase_12,
               **phase_13, **phase_14, **phase_15, **phase_16, **phase_17}
    common = dict(route="cuda", source="tpuddp_torch/ops/csrc/fused_adam.cu",
                  replaces="tpuddp/ops/fused_adam.py:71", design=DESIGN)
    flat = {d: {**t_flat[d], "max_abs_err": err_flat[d], "launches_by_path": (
        {k: n for k, n in phase_11_f32.items() if "ZeRO-1" in k} if d == torch.float32 else phase_11)}
        for d in t_flat}
    print(json.dumps({"kernels": [
        {"name": KERNEL_NAMES[torch.float32], **common, "launches": sum(by_path.values()),
         "max_abs_err": err_f32, **t_f32, "launches_per_step": launches_f32 // steps,
         "launches_by_path": by_path, "flat_shard": flat[torch.float32],
         "guarded": {**guard_14["kernel"][torch.float32], "launches_by_path": phase_14},
         "resnet50_161_leaves": {**resnet_15["kernels"][torch.float32], "launches_by_path": phase_15},
         "vgg16_32_leaves": {**vgg_16["kernels"][torch.float32], "launches_by_path": phase_16}},
        {"name": KERNEL_NAMES[torch.bfloat16], **common,
         "launches": (launches_bf16 + sum(ab_bf16.values()) + sum(phase_9_bf16.values())
                      + sum(phase_10_bf16.values()) + sum(phase_11.values())
                      + sum(phase_12_bf16.values())),
         "max_abs_err": err_bf16, **t_bf16, "library_note": NO_LIBRARY_BF16,
         "launches_per_step": launches_bf16 // steps_bf16,
         "launches_by_path": {"native bf16": launches_bf16,
                              **{f"native bf16 pipeline {k}": n for k, n in ab_bf16.items()},
                              **{k: 0 for k in phase_8}, "native digits": 0,
                              **{k: 0 for k in phase_9}, **phase_9_bf16,
                              **{k: 0 for k in phase_10}, **phase_10_bf16, **phase_11,
                              **{k: 0 for k in phase_11_f32}, **{k: 0 for k in phase_12},
                              **phase_12_bf16, **{k: 0 for k in phase_13},
                              **{k: 0 for k in phase_14}, **{k: 0 for k in phase_15},
                              **{k: 0 for k in phase_16}, **{k: 0 for k in phase_17}},
         "flat_shard": flat[torch.bfloat16],
         "guarded": {**guard_14["kernel"][torch.bfloat16], "library_note": NO_LIBRARY_BF16,
                     "launches_by_path": {}},
         "resnet50_161_leaves": {**resnet_15["kernels"][torch.bfloat16], "library_note": NO_LIBRARY_BF16,
                                 "launches_by_path": {k: 0 for k in phase_15}},
         "vgg16_32_leaves": {**vgg_16["kernels"][torch.bfloat16], "library_note": NO_LIBRARY_BF16,
                             "launches_by_path": {k: 0 for k in phase_16}}},
    ]}))
    phase("total", f"{time.perf_counter() - T0:.1f} s from the script's start (phase 10: {phase_10_s:.1f} s, "
          f"phase 11: {phase_11_s:.1f} s, phase 12: {phase_12_s:.1f} s, phase 13: {phase_13_s:.1f} s, "
          f"phase 14: {phase_14_s:.1f} s, phase 15: {phase_15_s:.1f} s, phase 16: {phase_16_s:.1f} s, "
          f"phase 17: {phase_17_s:.1f} s)")
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
