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
   no threads), each with its launches, the
   float32 ones at 2.9944 / 2.3076: step medians (steps 2-16) and the train
   pass's host stall per step; and the native row gather's ms per 128-row
   batch of a CIFAR-10-sized uint8 array beside numpy's, in turns;
7. resume at full width (AlexNet@224 b128 float32, ``checkpoint_epoch: 1``,
   in a temporary directory deleted afterwards; each file is 684 MB), for
   the native (``ckpt_{epoch}.npz``) and the managed (``state_{epoch}.npz``)
   path: 2 epochs straight, then a run with ``resume: true`` and
   ``keep_last: 1`` from the straight run's epoch-0 file (linked into its
   own directory, not trained and written again) for epoch 1: epoch 1's
   losses equal, the final
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
     depth 1): finite losses, the accuracy, 270
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
     and at ``scan_steps: 1``, in turns (replay, eager, 1): the accuracy,
     equal epoch rows, 450 launches, 1 capture and 9
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
     ``model: alexnet``, in turns (s2d, alexnet; 3 epochs each, the s2d
     turn the fast-file run above): epoch-3 step medians.

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
     turns (barrier, segmented, segmented, barrier; three rounds): their
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
     ``resnet50_s2d``, 224 px, one step per batch, in turns (plain, s2d):
     step medians, peak device memory, 4 launches per update;
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
     (flat, none, bf16_ef, flat), each with a ``step_stats`` window every 2
     updates and host 0's exporter (``observability: {exporter: true}``):
     each host's leader publishes its telemetry shard into a heartbeat
     directory both share (``$TPUDDP_HEARTBEAT_DIR``), and a thread of this
     script scrapes host 0's ``/snapshot``: process 0's pod view must hold
     both hosts. Both ranks log the world and the
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

18. remat (``training.remat: true``) and the cluster launcher:
   - "18 remat": ``cifar10_alexnet_h100.yaml``'s AlexNet@224 b128 float32,
     and the same at ``vgg16``@224: 8 updates one step per batch from one
     state and one dropout stream (flips and dropout on), plain and remat in
     turns (plain, remat), each wrap alone on the card: every
     run's losses, parameters, last gradients and moments bitwise the first
     plain run's, one Adam launch per update; each run's step median (steps
     2-8, each step synchronised) and peak device memory
     (``torch.cuda.max_memory_allocated``, reset before the run);
   - "18 remat buffers": toy_cnn@32 (BatchNorm, sync_bn) plain and remat, 8
     updates: bitwise, BatchNorm buffers included, every buffer moved;
   - "18 remat chunks": 3 chunks of 4 AlexNet remat steps eagerly and
     replayed: bitwise, 1 capture and 2 replays;
   - "18 remat entry point": ``cifar10_alexnet_h100.yaml`` one epoch at
     ``scan_steps: 1`` through the entry point's worker, plain and remat: the
     same losses to the bit;
   - "18 launcher": ``python -m tpuddp_torch.submit_job --dry_run`` with a
     ``local.gpu`` and a ``local.condor`` block: an executable
     ``launch_gpu.sh``, the reference ``.sub``, and each one's command run
     from the repository's root with ``--help`` (exit 0).
19. telemetry: ``cifar10_alexnet_h100.yaml`` one epoch through the entry
   point's worker with ``step_stats_every: 8`` and
   ``$TPUDDP_PROFILE_STEPS=4:12``, one step per batch and replayed
   (``scan_steps: 2``: updates 4-11 are four pure replays): the history
   valid under the port's validator, the header's ``device_kind``, the
   epoch row's p50/p95/p99 and ``mfu_p50``, two windows; from the trace the
   window's ten device operations by total time and the device idle share
   (1 - the union of the kernels' intervals over the span from the first
   device operation to the last).
20. the preemption drain and step snapshots (``training.snapshot``):
   - "20 preempt": per path (native, then managed), ``cifar10_alexnet_h100.yaml``
     (``..._managed_h100.yaml``) one synthetic epoch at ``scan_steps: 4``:
     straight without snapshots; with ``snapshot: {every_steps: 4,
     inflight: 1}`` and ``$TPUDDP_FAULT=preempt@step=6``, exit 75 and a
     ``{prefix}_0_s{N}.npz``
     with the v4 cursor; ``flightrec_preempt.json`` valid, its one
     ``preempt`` row and its notes' emergency step, final (and, native,
     flushed) snapshot step all N; the ``$TPUDDP_AUTO_RESUME=1`` rerun
     continuing at N, its epoch row and epoch file bitwise the straight
     run's (native at 2.9944 / 2.3076); Adam launches 16, N and 16 - N;
   - "20 SIGTERM": the native entry point's ``main`` in a process of its
     own (started with the preempt cycles and run beside them: most of its
     time is its start), 3 synthetic epochs of 64 steps one step per batch: SIGTERM 1 s
     after epoch 0's banner, exit 75 within the 25 s grace, the drain's
     step snapshot inside epoch 0 intact, a ``preempt`` event row, one Adam
     launch per update;
   - "20 snapshot turns": 1 epoch at ``scan_steps: 4``, snapshots (every
     4 steps, one held at a time) off, then on: rows bitwise, the step
     median, snapshots written and skipped, the writer's seconds and
     the loop's per step in the engine.
21. the elastic restart (``multihost_h100.yaml`` cut to 2 synthetic epochs,
   ``comm_hook: bf16_ef``, seed 0):
   - "21 watchdog": two host processes over Gloo on this card (as phase
     17) sharing one out_dir, ``$TPUDDP_WATCHDOG_TIMEOUT=5`` on both,
     ``hang@epoch=1`` on host 1: host 0 exits 76 within 5 + 5 s of the
     hang, its ``history.jsonl`` holds a ``watchdog_stale`` row naming
     process 1 with ``lag_s`` >= 5, ``ckpt_0.npz`` holds a world-2
     ``per_replica`` residual, and host 0's watchdog dumped a valid
     ``flightrec_watchdog.json`` holding epoch 0's row; host 1 is killed;
   - "21 supervisor": the port's restore of that file at world 1 in this
     process (the residual bitwise the float32 sum of the file's two rows),
     then ``python -m tpuddp_torch.supervise --world 1 --backoff-base 0.1
     --first-env TPUDDP_FAULT=crash@step=5 --flight-dir <out_dir>`` over
     the entry point on the same out_dir without the rendezvous,
     ``$TPUDDP_AUTO_RESUME=1``: the watchdog's recording summarized once,
     before attempt 0;
     history ``[(0, 113, 1), (1, 0, 1)]``, a ``topology_change`` (2 -> 1,
     redistributed) per attempt, attempt 1's Adam launches its updates
     times the tables; each attempt's wall seconds and the losses.
22. step snapshots and the agreed drain at world 2 on one host, and
   ``training.mode: auto``:
   - "22 mode auto": one epoch of ``cifar10_alexnet_h100.yaml`` at
     ``mode: auto`` at world 1 (16 updates, 16 Adam launches, 2.9944 /
     2.3076: at world 1 the global batch is the batch), and one AlexNet@224
     b128 step (dropout 0) on the card against the CPU from one state: the
     loss within 1e-4, the gradient's distance printed, beside the same
     distance of the plain step (``mode: shard_map``);
   - "22 snapshots world 2": two rank processes this script starts, each
     the port's rank worker as local rank 0 of 1 at world 2 against a
     store the script holds (one host; Gloo on this card), every turn in
     both: ``cifar10_resnet18_small_h100.yaml`` 2 synthetic epochs,
     ``bf16_ef``, ZeRO-1, snapshots every 4 steps off, then on as (a) the
     uninterrupted run; (b) ``preempt@step=12``: exit 75 on both ranks,
     one ``preempt`` row inside epoch 1 with its step snapshot; (c) the
     auto-resumed run, continued at that step: its epoch rows and
     ``ckpt_1.npz`` bitwise (a)'s, its last parameters (a)'s on both
     ranks; the same snapshots taken on both ranks, written by rank 0;
     as many agreements on both ranks; one Adam launch per ZeRO-1 update
     on each rank; a ``mode: auto`` pair (``sync_bn``, no hook) whose
     ranks hold bitwise equal parameters at both epoch saves; then the
     agreed poll alone, 500 exchanges back to back. Printed: the
     snapshots, the loop's ms a step in the engine on each rank, the
     poll's ms an exchange (in each turn, and alone), the epoch-2 step
     medians off and on.
23. the live plane (the ``observability`` block): ``cifar10_alexnet_h100.yaml``
   one synthetic epoch one step per batch (the host-bound case) a run,
   through the entry point's worker, in five variants in turns there and
   back (``LIVE_TURNS``): off (``observability: false``, no ``step_stats``
   window), the windows alone (every 4 updates), the plane alone (the
   exporter and tracing; the flight recorder and aggregation by default),
   the plane with the windows unscraped, and scraped every 20 ms by a
   thread of this process (``/metrics`` and ``/snapshot`` of the port in
   the run's ``exporter.port``); the epoch-end save replaced by clones of
   the parameters and moments on the card: losses, parameters and moments
   bitwise in every run, 16 Adam launches each, as many
   ``torch.cuda.synchronize`` and ``Tensor.item`` calls (counted by
   wrappers; ``Event.synchronize`` printed: the windows' waits);
   ``train_steps_total`` monotone up to 16, every response whole; the
   first scraped run's header (the bound port, the tracer), four windows,
   one ``trace_summary`` row, ``trace_train.json`` valid under the port's
   validator with the epoch, stage, dispatch and readback spans (and the
   collective annotations where the segmented overlap resolved on); a
   clean exit leaves no flight recording and no port file; each run's step
   median.
24. the transformer family: ``transformer_small`` at full width (d 128, 8
   heads, 4 layers, 256 positions, vocabulary 256), its weights converted
   from one seeded JAX-layout tree drawn with numpy:
   - "24 forward": a (8, 256) token batch on the card against the port's
     CPU forward, TF32 off, within rtol/atol 1e-4;
   - "24 decode": the decode defaults' pools (8 slots, 64 blocks of 16),
     three prompts of 17, 40 and 64 tokens prefilled at their buckets,
     then 32 greedy ``decode_step`` s of every slot, eagerly and replayed
     from one captured CUDA graph: the replay bitwise the eager run
     (tokens, logits, pools), every sequence's 33 tokens those of greedy
     decoding by repeated full forwards on the card; ms a step each way;
   - "24 steps": the first 3 steps' losses (64 sequences of 256 tokens a
     step) on the card within rtol 1e-3 of the CPU port's from the same
     state, then chunks of 16 (eager, captured, replayed): the replayed
     step's ms, tokens/s and MFU, 2 Adam launches an update;
   - "24 training": the token job through ``run_ddp_training`` at world 1
     (the token loader, 64 x 256 tokens a step, 2 epochs of 16 steps, Adam
     float32), eagerly and at ``scan_steps: auto`` with graph replay in
     turns (eager, replay, replay, eager): finite losses that fall, every
     token counted, 2 Adam launches an update, the epoch rows and the final
     checkpoint's parameters, moments and step counts bitwise across runs,
     ``mfu_p50`` a number, each run's epoch-2 step median;
   - "24 adam": the float32 kernel against its plain version over the 52
     leaves (2 launch tables), then timed with the plain version and
     ``torch.optim.Adam(fused=True)`` beside its 28-byte-a-parameter bound,
     and replayed from a CUDA graph beside the library's graph.
25. tensor parallel: ``transformer_small`` at full width (as phase 24) at
   ``parallel: {model: 2}`` on a world of 2 (data 1) on the one card over
   Gloo (two rank processes this script starts, as phase 22's), the
   native entry point's ``build_training`` and ``run_training_loop``,
   eagerly (a Gloo collective cannot be captured):
   - "25 forward": each rank's ``tp_forward`` of an (8, 256) batch against
     the card's model-1 forward of the gathered weights, atol 2e-5;
   - "25 steps": 8 train steps (8 epochs of one (8, 256) batch) through the
     loop: each step's loss within 1e-4 of a world-1 model-1 run of the same
     global batches on the card; the model-axis collectives exactly 19 a
     train step (10 forward, 9 backward) on each rank; the Adam kernel's
     launches 2 an update on each rank (the local shard's 52 leaves);
   - "25 checkpoint": the model-2 file of the last epoch restored here at
     world 1, model 1, with ``reshard_on_mismatch``: the parameters bitwise
     the ranks' gathered ones;
   - "25 times": the eager TP step's median ms beside the model-1 step's,
     and the float32 kernel over one rank's local shard (447,488
     parameters, 2 tables) against its plain version, timed beside its
     bound and ``torch.optim.Adam(fused=True)``, each with the card's name
     and power limit;
   - "25 snapshots": the same two rank processes after (a)-(d), each leg
     in a process group of its own, 2 epochs of 4 batches, a step snapshot
     every 2 steps: two turns, snapshots off then on (the latter the
     straight run), then ``preempt@step=5`` (the drain's ``SystemExit(75)``
     on both ranks at one step; a v4 step file of the model-2 topology),
     then the auto-resumed run: its epoch rows and a digest of the gathered
     parameters and moments bitwise the straight run's; the step file
     restored here at model 1 through the reshaper bitwise the parameters
     the ranks gathered from it; "25 snapshot times": the step medians with
     snapshots off and on.
26. serving (:mod:`tpuddp_torch.serving`), from
   ``tpuddp_torch/configs/cifar10_alexnet_serving_h100.yaml``'s ``serving``
   block and its ``decode`` sub-block, the Adam kernels' counts set to 0
   just before each engine's traffic and read just after (0: serving runs
   no optimizer):
   - "26 serving": the request engine over AlexNet@224 (10 classes) on
     cuda:0, restored through the integrity path from a native checkpoint
     of a seeded init that this phase saves; 64 seeded requests of 1-4 rows
     from 2 tenants at once: every request's logits bitwise a direct
     forward of its padded batch on the card, 4 within 1e-4 of the CPU
     forward, no rejects; images/s, e2e latency p50 and p99, batch
     occupancy;
   - "26 decode": the decode engine over transformer_small at full width (8
     slots, 129 blocks of 16, 64 greedy tokens); 32 seeded prompts of
     1-192 tokens from 4 tenants at once: 4 streams re-run alone bitwise,
     2 those of repeated full forwards on the card, one graph capture and
     then replays only; two replicas on ``[cuda:0, cuda:0]`` under
     ``$TPUDDP_FAULT=replica_kill@step=40``: every stream bitwise the
     undisturbed run, with ``session_failover`` events; ``pool_poison``:
     rebuilt, captured again, bitwise, and a poisoned replica's next
     dispatch raises; tokens/s, TTFT and ITL p50 and p99, peak KV
     occupancy, a step replayed against eager;
   - "26 entry": ``python -m tpuddp_torch.serving --decode --demo 16
     --serve 30`` on that file, SIGTERM once the demo is submitted: exit
     75, the last line the JSON summary with all 16 sequences finished,
     ``history.jsonl`` valid.
27. the fleet: ``python -m tpuddp_torch.fleet chaos-demo`` cut for one card
   (:func:`tpuddp_torch.fleet.__main__.run_chaos_demo`; every job at world
   1 on cuda:0, a pool of three slots): two ``digits_h100.yaml`` training
   jobs with a checkpoint each epoch, a toy_mlp serving job of up to two
   replicas on ``[cuda:0, cuda:0]`` and a late arrival of priority 100.
   "27 fleet": one job SIGKILLed and resumed with every epoch; one endorsed
   tuner action (``pipeline_sync_readback``) through drain and relaunch,
   the relaunched header carrying ``tuning``; that job displaced by the
   arrival through the drain (exit 75, its emergency checkpoint, never a
   SIGKILL); the serving job autoscaled 1 -> 2 replicas through
   ``$TPUDDP_SERVING_REPLICAS`` on an SLO no batch meets; every history
   valid; each training attempt's Adam launches, as the job reports them.
   "27 times": seconds from the SIGKILL to the resumed header and first
   epoch, from each SIGTERM to exit 75 and to the relaunched header and
   first epoch, from the scale-up to the 2-replica header.

Every launch count is the kernel's own: block 0 of each launch adds one to
a word on the card, so a launch replayed from a CUDA graph counts as an
eager one does, and a graph that lost its Adam node would count none.

Then one JSON line with the fused steps' numbers, one with phase 10's, one
with phase 11's, one with phase 12's (with each hook's gradient bytes per
update on AlexNet at world 1 and, counted, at world 8), one with phase
13's, one with phase 14's, one with phase 15's, one with phase 16's, one with
phase 17's, one with phase 18's, one with phase 19's, one with phase 20's, one with
phase 21's, one with phase 22's, one with phase 23's, one with phase 24's, one with
phase 25's, one with phase 26's, one with phase 27's, one with the optimizers', one
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
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
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
from tpuddp_torch.data.tokens import TokenLMLoader, token_loaders  # noqa: E402
from tpuddp_torch.data.transforms import make_eval_transform, make_train_augment  # noqa: E402
from tpuddp_torch.models import AlexNet, load_model  # noqa: E402
from tpuddp_torch.models import transformer as tf_lib  # noqa: E402
from tpuddp_torch.models.convert import (  # noqa: E402
    JaxFlatOrder, flat_to_jax, jax_leaf_index, jax_sizes, state_dict_from_jax,
)
from tpuddp_torch.models.pretrained import pretrained_from_config  # noqa: E402
from tpuddp_torch.observability import aggregate as aggregate_lib  # noqa: E402
from tpuddp_torch.observability import schema  # noqa: E402
from tpuddp_torch.observability.recorder import count_step_flops, device_peak_flops  # noqa: E402
from tpuddp_torch.nn import CrossEntropyLoss  # noqa: E402
from tpuddp_torch.nn.norm import BatchNorm, convert_sync_batchnorm  # noqa: E402
from tpuddp_torch.ops import fused_adam  # noqa: E402
from tpuddp_torch.optim import Adam  # noqa: E402
from tpuddp_torch.parallel import backend, collectives, comm  # noqa: E402
from tpuddp_torch.parallel import tensor as tp_lib  # noqa: E402
from tpuddp_torch.parallel.ddp import DistributedDataParallel  # noqa: E402
from tpuddp_torch.parallel.spawn import run_ddp_training  # noqa: E402
from tpuddp_torch.resilience import faults, preemption  # noqa: E402
from tpuddp_torch.resilience import guard as guard_lib  # noqa: E402
from tpuddp_torch.serving import ServingEngine  # noqa: E402  (sets $CUBLAS_WORKSPACE_CONFIG)
from tpuddp_torch.serving.decode import DecodeEngine  # noqa: E402
from tpuddp_torch.serving.replica import seeded_model  # noqa: E402
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
PIPELINE_TURNS = ("false", "default", "no threads")
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
    """One line of a phase, ending in the seconds since the script began."""
    print(f"[{name}] {msg} [t={time.perf_counter() - T0:.1f} s]", flush=True)


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


def _file_compare(a_path: str, b_path: str):
    """``(every array equal, max |d| over the float arrays)`` of two
    checkpoint files: the sha256 of each file, from its sidecar, first
    (equal bytes are equal arrays, with no 685 MB load), the arrays only
    when the bytes differ."""
    digests = [ckpt.read_manifest(p) for p in (a_path, b_path)]
    if all(digests) and digests[0] == digests[1]:
        return True, 0.0
    a, b = _arrays(a_path), _arrays(b_path)
    equal = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    dp = max((float(np.abs(a[k].astype(np.float64) - b[k].astype(np.float64)).max())
              for k in a if k in b and a[k].dtype.kind == "f"), default=math.inf)
    return equal, dp


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
    # the resume's source: the straight run's epoch-0 file, linked (the same
    # bytes a 1-epoch run writes, without training and writing them again)
    os.makedirs(resumed, exist_ok=True)
    for name in (f"{prefix}_0.npz", f"{prefix}_0.npz.sha256"):
        os.link(os.path.join(straight, name), os.path.join(resumed, name))
    t0 = time.perf_counter()
    again, launches = run(resumed, num_epochs=2, resume=True, keep_last=1)
    resumed_s = time.perf_counter() - t0
    equal, dp = _file_compare(os.path.join(straight, f"{prefix}_1.npz"),
                              os.path.join(resumed, f"{prefix}_1.npz"))
    kept = sorted(f for f in os.listdir(resumed) if f.startswith(f"{prefix}_"))
    checks = {
        "epoch 1 resumed alone": [r["epoch"] for r in again] == [1],
        "epoch 1's losses equal": (again[0]["train_loss"], again[0]["test_loss"]) == (
            whole[1]["train_loss"], whole[1]["test_loss"]),
        "max |dp| = 0 over parameters and moments": dp == 0.0,
        "every array equal": equal,
        ("16 float32-kernel launches in the resumed run" if adam else "no Adam-kernel launch"): (
            launches[fused_adam.kernel.symbol] == (16 if adam else 0)
            and sum(launches.values()) == launches[fused_adam.kernel.symbol]),
        f"keep_last 1 kept {prefix}_1.npz alone": kept == [f"{prefix}_1.npz", f"{prefix}_1.npz.sha256"],
    }
    if kind == "native" and adam:
        checks["epoch 0 at 2.9944 / 2.3076"] = (
            round(whole[0]["train_loss"], 4), round(whole[0]["test_loss"], 4)) == F32_LOSSES
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


FUSED_TURNS = ("replay", "eager", "depth 1")


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

NATIVE_TURNS = ("replay", "eager", "depth 1")
ALEXNET_TURNS = ("auto", "depth 1")


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
          f"{'/'.join(NATIVE_TURNS)} (launches: each mode's run): step median (epochs 3-10) ms "
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
          f"16 train / 6 eval) against scan_steps 1, launches of each run: epoch rows equal ({', '.join(f'{a:.4f}/{b:.4f}' for a, b, _ in rows['auto'])}); "
          f"launches {launches}; captures/replays {_kinds(g)}, capture_s={g['capture_s']:.3f}; turns "
          f"{'/'.join(ALEXNET_TURNS)}: epoch-3 step median ms "
          + "; ".join(f"{m} [{fmt(v)}]" for m, v in medians.items())
          + f" (auto/depth 1 {min(medians['auto']) / min(medians['depth 1']):.3f}, least of each)")
    return dict(medians=medians, launches=launches, rows_equal=same, capture_s=g["capture_s"], graphs=_kinds(g))


EVAL_TURNS = ("groups", "depth 1")


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

STEM_TURNS = ("s2d", "alexnet")
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
    keep different ones of equal magnitude (``ties`` counts them). The
    comparison runs on the card (exact either way; the CPU's 57 M-element
    passes took seconds a hook)."""
    cpu, send = cpu.to(card.device), send.to(card.device)
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
    # the all-zero bucket and the NaN bucket in one vector: every hook treats
    # each bucket on its own, so one pass over the 57 M elements holds both
    poisoned = {"plain": g_vec, "zero and nan buckets": g_vec.clone()}
    poisoned["zero and nan buckets"][zero[0]:zero[1]] = 0
    poisoned["zero and nan buckets"][buckets[-1][0] + 3] = float("nan")
    out = {}
    t_agree = time.perf_counter()
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
            if case != "plain" and hook == "bf16" and cpu_out[zero[0]:zero[1]].any():
                raise SystemExit("chip_smoke: bf16's all-zero bucket sent non-zeros")
            if case != "plain":
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
    agree_s = time.perf_counter() - t_agree
    # the round trips, in turns
    t_turns = time.perf_counter()
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
          f"the plain sync's flatten and copy back); agreement {agree_s:.1f} s, round trips "
          f"{time.perf_counter() - t_turns:.1f} s")
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
OVERLAP_K, OVERLAP_CHUNKS, OVERLAP_ROUNDS = 4, 3, 3


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
    seconds = {}  # each run's: (its wrap built, its chunks run)
    for label, replay in OVERLAP_RUNS:
        t0 = time.perf_counter()
        gc.collect()  # earlier wraps and their graphs, which cycles may hold
        torch.cuda.empty_cache()
        ddp = _overlap_ddp(hook, label == "segmented", replay, init, accum)
        t1 = time.perf_counter()
        if label == "segmented":
            meta = ddp.comm_overlap_meta
        torch.cuda.manual_seed(7)
        reset_counts()
        graphs.reset_stats()
        for c in range(OVERLAP_CHUNKS):
            ddp.train_step_many(batches[c * k:(c + 1) * k])
        torch.cuda.synchronize()
        run = f"{label} {'replay' if replay else 'eager'}"
        seconds[run] = (round(t1 - t0, 2), round(time.perf_counter() - t1, 2))
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
          f"seconds (wrap, chunks) {seconds}; {time.perf_counter() - started:.1f} s")
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
RESNET_TURNS = ("resnet50", "resnet50_s2d")


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
# flat, hierarchical none and bf16_ef, and flat again (the repeated run)
MULTIHOST_TURNS = ("flat", "hierarchical none", "hierarchical bf16_ef", "flat")
MULTIHOST_S = 600
# the live plane rides every turn: a step_stats window every 2 updates (each
# host's leader publishes its telemetry shard there into a heartbeat
# directory both hosts share, $TPUDDP_HEARTBEAT_DIR), host 0's exporter,
# which the script scrapes for the pod view
MULTIHOST_LIVE = {"step_stats_every": 2}
MULTIHOST_OBS = {"exporter": True}
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
                                    scan_steps=1, seed=0, **MULTIHOST_LIVE,
                                    **MULTIHOST_TOPOLOGIES[label])
        settings["observability"] = MULTIHOST_OBS
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
    hb = os.path.join(root, "heartbeats")
    stop = threading.Event()
    pods = {run["dirs"][0]: [] for run in runs}
    scraper = threading.Thread(target=_scrape_pods, args=(pods, stop), daemon=True)
    t0 = time.perf_counter()
    for pid in (0, 1):
        env = dict(os.environ, TPUDDP_BACKEND="gloo", TPUDDP_PROCESS_ID=str(pid),
                   TPUDDP_WORLD_SIZE="2", PYTHONPATH=ROOT, TPUDDP_HEARTBEAT_DIR=hb)
        for var in ("TPUDDP_COORDINATOR", "TPUDDP_NUM_PROCESSES", "TPUDDP_WATCHDOG_TIMEOUT"):
            env.pop(var, None)
        procs.append(subprocess.Popen([sys.executable, "-c", HOST_SCRIPT, *paths[pid]], cwd=ROOT,
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    scraper.start()
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MULTIHOST_S))
    finally:
        stop.set()
        scraper.join(timeout=30)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall_s = time.perf_counter() - t0
    for run in runs:
        run["pod_hosts"] = pods[run["dirs"][0]]
    shards = {pid: aggregate_lib.read_shard(hb, pid) for pid in (0, 1)}
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
    return runs, wall_s, shards


def _scrape_pods(pods: dict, stop: threading.Event) -> None:
    """While the hosts run: each turn's host-0 exporter (named in its port
    file once ``/healthz`` answers) scraped for the pod view's hosts
    reporting (``pod_hosts_reporting``), appended to ``pods[dir]``."""
    import urllib.request

    from tpuddp_torch.observability.exporter import read_live_port

    while not stop.is_set():
        for d, seen in pods.items():
            port = read_live_port(d, probe_timeout=0.2) if os.path.exists(
                os.path.join(d, "exporter.port")) else None
            if port is None:
                continue
            try:
                series = json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/snapshot", timeout=2).read())["series"]
            except OSError:
                continue
            value = series.get("pod_hosts_reporting", {}).get("value")
            if value is not None:
                seen.append(value)
        stop.wait(0.05)


def _multihost_checks(run):
    """The run's own checks: both ranks at world 2, 2 hosts x 1 local;
    host 0 alone writes; the Adam kernel's launches per update."""
    label, (out0, out1), (d0, d1) = run["label"], run["stdout"], run["dirs"]
    records = [json.loads(l) for l in open(os.path.join(d0, "history.jsonl"))]
    history = [r for r in records if r["type"] == "epoch"]
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
        "the history opens with host 0's run_meta header": records[0]["type"] == "run_meta"
        and (records[0]["process_count"], records[0]["process_index"]) == (2, 0),
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
        turns, wall_s, shards = multihost_runs(root)
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
        pod = {run["label"] + f" turn {i}": max(run["pod_hosts"], default=0)
               for i, (run, _, _) in enumerate(runs)}
        stragglers = sum(r.get("event") == "straggler" for run, _, _ in runs
                         for r in map(json.loads, open(os.path.join(run["dirs"][0], "history.jsonl"))))
        checks = {
            "process 0's aggregator saw hosts 0 and 1": max(pod.values()) == 2,
            "each host's shard in the shared heartbeat directory": all(
                shard is not None and shard["window_index"] > 0 and shard["epoch"] == 0
                for shard in shards.values()),
            "hierarchical none bitwise flat": diffs["hierarchical none vs flat"] == 0.0,
            "repeated runs bitwise": all(v == 0.0 for k, v in diffs.items() if k.endswith("repeated")),
            "bf16_ef within loss_parity_tol of flat": all(
                abs(bf16[0][k] - flat[0][k]) <= tol[k] for k in tol),
            "bf16_ef residual finite and not all zero": bool(np.isfinite(residual).all()
                                                             and np.any(residual != 0)),
        }
        failed = [c for c, ok in checks.items() if not ok]
        if failed:
            raise SystemExit(f"chip_smoke: 17 multihost: failed {failed}: pod {pod}, shards {shards}, "
                             f"diffs {diffs}, tol {tol}, "
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
              "processes, each running every turn); live plane: hosts in host 0's pod view per turn "
              f"{pod} (its /snapshot scraped), {stragglers} straggler rows, shards " + json.dumps(
                  {pid: {k: shard[k] for k in ("window_index", "epoch", "step", "step_time_ms_p50")}
                   for pid, shard in shards.items()}))
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
            "pod_hosts_reporting": pod,
            "straggler_rows": stragglers,
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["alexnet_bytes"] = multihost_bytes()
    return out


# ---------------------------------------------------------------- phase 18 --

# remat against plain: (label, model name, image size), the runs' order
# (each from one state and one dropout stream), the updates of a run
REMAT_MODELS = (("AlexNet@224", "alexnet", 224), ("vgg16@224", "vgg16", 224))
REMAT_TURNS = ("plain", "remat")
REMAT_STEPS, REMAT_K = 8, 4


def _remat_init(name: str, size):
    """Registry model ``name``'s initial weights at ``size`` px (None: 32),
    drawn on the card from a seed."""
    torch.manual_seed(0)
    with torch.device("cuda"):
        model = load_model(name, 10, input_shape=(size or 32, size or 32, 3))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _remat_ddp(name: str, size, init, remat: bool, replay: bool = False):
    """A native wrap of registry model ``name`` holding the weights
    ``init`` (flips and dropout on), with or without remat."""
    with torch.device("meta"):
        model = load_model(name, 10, input_shape=(size or 32, size or 32, 3))
    model.to_empty(device="cuda").load_state_dict(init)
    if any(isinstance(m, BatchNorm) for m in model.modules()):
        convert_sync_batchnorm(model)
    gen = torch.Generator().manual_seed(1)
    ddp = DistributedDataParallel(model, Adam(model.parameters(), lr=1e-3), CrossEntropyLoss(),
                                  augment=make_train_augment(size=size, flip=True, generator=gen),
                                  device="cuda", generator=gen, remat=remat)
    ddp._graph_replay = replay
    return ddp


def _remat_state(ddp):
    """Parameters, last gradients, moments (and the residual) with the
    model's buffers, cloned."""
    state = _ddp_state(ddp)
    state.update({f"buffer/{n}": b.clone() for n, b in ddp.model.named_buffers()})
    return state


def remat_turns(label: str, name: str, size, batches):
    """18 (a): ``REMAT_STEPS`` updates one step per batch from one state and
    one dropout stream, plain and remat in turns (``REMAT_TURNS``), each wrap
    alone on the card: every run's losses and state bitwise the first plain
    run's, one Adam launch per update; the step median (steps 2-8, each step
    synchronised) and each run's peak device memory: the most allocated
    during the run less what was allocated before its wrap was built (the
    weights it starts from, the earlier runs' states), so the wrap's own
    parameters, gradients, moments and activations."""
    init = _remat_init(name, size)
    runs = []
    for mode in REMAT_TURNS:
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        ddp = _remat_ddp(name, size, init, mode == "remat")
        torch.cuda.manual_seed(7)
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for batch in batches[:REMAT_STEPS]:
            t0 = time.perf_counter()
            losses.append(ddp.train_step(batch))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        runs.append(dict(mode=mode, state=_remat_state(ddp), losses=torch.stack(losses),
                         peak_gb=(torch.cuda.max_memory_allocated() - before) / 1e9,
                         median=statistics.median(times[1:]), launches=fused_adam.kernel.launches))
        del ddp
    init.clear()
    ref = runs[0]
    diffs = [max(_max_diff(ref["state"], r["state"]), float((ref["losses"] - r["losses"]).abs().max()))
             for r in runs[1:]]
    moved = [k for k in ref["state"] if k.startswith("buffer/")]
    checks = {
        "every run bitwise the first plain run (losses, parameters, gradients, moments, buffers)":
            all(d == 0.0 for d in diffs),
        "1 Adam launch per update": all(r["launches"] == REMAT_STEPS for r in runs),
        "finite losses": all(bool(torch.isfinite(r["losses"]).all()) for r in runs),
    }
    failed = [c for c, ok in checks.items() if not ok]
    by_mode = {m: [r for r in runs if r["mode"] == m] for m in ("plain", "remat")}
    out = dict(turns=list(REMAT_TURNS), max_abs_diff=diffs, buffers=len(moved),
               step_ms_median={m: [r["median"] for r in rs] for m, rs in by_mode.items()},
               peak_gb={m: [r["peak_gb"] for r in rs] for m, rs in by_mode.items()},
               launches=[r["launches"] for r in runs])
    if failed:
        raise SystemExit(f"chip_smoke: 18 remat {label} failed {failed}: {out}")
    plain, remat = (statistics.median(out["step_ms_median"][m]) for m in ("plain", "remat"))
    phase("18 remat", f"{label} b128 float32 (flips, dropout), {REMAT_STEPS} updates one step per batch "
          f"from one state, turns {'/'.join(REMAT_TURNS)}: max |d| vs the first plain run {diffs} "
          f"(bitwise: losses, parameters, gradients, moments, {len(moved)} buffers); Adam launches "
          f"{out['launches']}; step median (steps 2-{REMAT_STEPS}) plain "
          + "/".join(f"{t:.2f}" for t in out["step_ms_median"]["plain"]) + " ms, remat "
          + "/".join(f"{t:.2f}" for t in out["step_ms_median"]["remat"])
          + f" ms (remat/plain {remat / plain:.3f}); peak memory plain "
          + "/".join(f"{g:.3f}" for g in out["peak_gb"]["plain"]) + " GB, remat "
          + "/".join(f"{g:.3f}" for g in out["peak_gb"]["remat"]) + " GB")
    del runs, ref
    torch.cuda.empty_cache()
    return out


def remat_buffers(batches):
    """18 (b): toy_cnn@32 (BatchNorm, sync_bn) plain and remat, 8 updates
    from one state: bitwise, and the running buffers moved (advanced once a
    step: a second advance in the recompute would part them from plain)."""
    init = _remat_init("toy_cnn", None)
    states = {}
    for mode in ("plain", "remat"):
        ddp = _remat_ddp("toy_cnn", None, init, mode == "remat")
        reset_counts()
        for batch in batches[:REMAT_STEPS]:
            ddp.train_step(batch)
        states[mode] = _remat_state(ddp)
        del ddp
    moved = all(not torch.equal(states["plain"][f"buffer/{k}"], v.to("cuda")) for k, v in init.items()
                if k.endswith(("running_mean", "running_var")))
    diff = _max_diff(states["plain"], states["remat"])
    if diff != 0.0 or not moved or fused_adam.kernel.launches != REMAT_STEPS:
        raise SystemExit(f"chip_smoke: 18 remat toy_cnn: max |d| {diff}, buffers moved {moved}, "
                         f"launches {fused_adam.kernel.launches}")
    phase("18 remat buffers", f"toy_cnn@32 b128 sync_bn, {REMAT_STEPS} updates plain and remat from one "
          f"state: max |d| {diff} (bitwise, BatchNorm buffers included), every running buffer moved")
    return dict(max_abs_diff=diff, buffers_moved=moved, launches=REMAT_STEPS)


def remat_chunks(batches):
    """18 (c): 3 chunks of ``REMAT_K`` AlexNet@224 remat steps from one
    state, eagerly and replayed (warm-up, capture, replay): bitwise, one
    Adam launch per update, 1 capture and 2 replays."""
    init = _remat_init("alexnet", 224)
    runs = {}
    for mode in ("eager", "replay"):
        gc.collect()
        torch.cuda.empty_cache()
        ddp = _remat_ddp("alexnet", 224, init, True, replay=mode == "replay")
        torch.cuda.manual_seed(7)
        reset_counts()
        graphs.reset_stats()
        sums = None
        for c in range(3):
            sums = ddp.train_step_many(batches[c * REMAT_K:(c + 1) * REMAT_K], sums)
        torch.cuda.synchronize()
        runs[mode] = dict(state=_remat_state(ddp), sums=sums.clone(), launches=fused_adam.kernel.launches,
                          graphs=_kinds(graphs.stats))
        del ddp
    diff = max(_max_diff(runs["eager"]["state"], runs["replay"]["state"]),
               float((runs["eager"]["sums"] - runs["replay"]["sums"]).abs().max()))
    checks = {
        "replay bitwise eager": diff == 0.0,
        "1 Adam launch per update": all(r["launches"] == 3 * REMAT_K for r in runs.values()),
        "1 capture, 2 replays": runs["replay"]["graphs"] == {"train": (1, 2)},
    }
    failed = [c for c, ok in checks.items() if not ok]
    out = dict(max_abs_diff=diff, launches={m: r["launches"] for m, r in runs.items()},
               graphs=runs["replay"]["graphs"])
    if failed:
        raise SystemExit(f"chip_smoke: 18 remat chunks failed {failed}: {out}")
    phase("18 remat chunks", f"AlexNet@224 b128 remat, 3 chunks of {REMAT_K} from one state eagerly and "
          f"replayed (the dropout draws recorded in the forward, nothing reads the generator in the "
          f"capture): max |d| {diff} (bitwise), Adam launches {out['launches']}, graphs {out['graphs']}")
    return out


def remat_entry():
    """18 (d): ``cifar10_alexnet_h100.yaml`` one epoch at ``scan_steps: 1``
    through the entry point's worker, plain and with ``remat: true``: the
    same losses to the bit, one Adam launch per step each."""
    out = {}
    for mode in ("plain", "remat"):
        history, wall_s, launches = native_run(SETTINGS, {"scan_steps": 1, "remat": mode == "remat"})
        row = history[0]
        out[mode] = dict(train_loss=row["train_loss"], test_loss=row["test_loss"],
                         launches=launches[fused_adam.kernel.symbol], wall_s=wall_s,
                         step_ms_median=statistics.median(row["step_ms"][1:]))
    same = all(out["plain"][k] == out["remat"][k] for k in ("train_loss", "test_loss"))
    if not same or any(r["launches"] != 16 for r in out.values()):
        raise SystemExit(f"chip_smoke: 18 remat entry point: {out}")
    phase("18 remat entry point", f"cifar10_alexnet_h100.yaml, one epoch at scan_steps 1, plain / remat: "
          f"train_loss {out['plain']['train_loss']!r} / {out['remat']['train_loss']!r}, test_loss "
          f"{out['plain']['test_loss']!r} / {out['remat']['test_loss']!r} (bitwise), 16 Adam launches each, "
          f"step median {out['plain']['step_ms_median']:.2f} / {out['remat']['step_ms_median']:.2f} ms")
    return out


def launcher_checks(root: str):
    """18 (e): ``python -m tpuddp_torch.submit_job --dry_run`` on
    ``cifar10_alexnet_h100.yaml`` with a ``local.gpu`` block and with the
    reference's ``local.condor`` block: an executable ``launch_gpu.sh`` and
    the reference ``.sub``; the command each writes runs from the
    repository's root on this machine (with ``--help``: exit 0)."""
    import shlex

    import yaml

    settings = cfg_lib.load_settings(SETTINGS)
    out = {}
    blocks = (("gpu", {"device": "cuda", "gpu": {"num_gpus": 1}}),
              ("condor", {"device": "cuda", "condor": {"bid": 50, "num_cpus": 8, "memory_cpus": 96000,
                                                        "num_gpus": 1, "memory_gpus": 80000}}))
    # both blocks' launchers at once, then both written commands at once (each
    # a process start): the same runs, side by side
    submits = {}
    for block, local in blocks:
        path = os.path.join(root, f"{block}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump({**settings, "out_dir": os.path.join(root, block), "local": local}, f)
        submits[block] = subprocess.Popen([sys.executable, "-m", "tpuddp_torch.submit_job",
                                           "--settings_file", path, "--dry_run"], cwd=ROOT,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    commands = {}
    for block, _ in blocks:
        out_dir = os.path.join(root, block)
        _, err = submits[block].communicate(timeout=300)
        if submits[block].returncode != 0:
            raise SystemExit(f"chip_smoke: 18 launcher {block}: {err}")
        if block == "gpu":
            script = os.path.join(out_dir, "launch_gpu.sh")
            text = open(script).read()
            line = text.strip().splitlines()[-1]
            command = shlex.split(line.split(" 2>&1")[0])[1:]
            ok = os.access(script, os.X_OK) and "set -euo pipefail" in text and "info_${HOSTNAME}.log" in text
        else:
            text = open(os.path.join(out_dir, "submission_file.sub")).read()
            args = next(line for line in text.splitlines() if line.startswith("arguments = "))
            command = shlex.split(args[len("arguments = "):].strip('"'))
            ok = (f"executable = {sys.executable}" in text and "request_gpus = 1" in text
                  and "TARGET.CUDAGlobalMemoryMb > 80000" in text and text.rstrip().endswith("queue"))
        commands[block] = (ok, command, text, subprocess.Popen(
            [sys.executable, *command, "--help"], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    for block, (ok, command, text, ran) in commands.items():
        _, err = ran.communicate(timeout=300)
        if not ok or ran.returncode != 0:
            raise SystemExit(f"chip_smoke: 18 launcher {block}: contract {ok}, {command} --help exited "
                             f"{ran.returncode}: {err[-500:]}")
        out[block] = " ".join(command)
        phase("18 launcher", f"local.{block} --dry_run: {text.splitlines()[0] if block == 'condor' else script}"
              f"; `python {out[block]} --help` from the repository's root exited 0")
    return out


def remat_phase():
    """Phase 18: remat against plain on AlexNet and vgg16 at 224 px, the
    buffers, a replayed chunk, the entry point; the launcher."""
    batches = _guard_batches(max(REMAT_STEPS, 3 * REMAT_K), 8)
    turns = {label: remat_turns(label, name, size, batches) for label, name, size in REMAT_MODELS}
    buffers = remat_buffers(batches)
    chunks = remat_chunks(batches)
    entry = remat_entry()
    root = tempfile.mkdtemp(prefix="tpuddp_torch_launch_")
    try:
        launcher = launcher_checks(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {
        **{f"native {label} {mode} turn {i} (phase 18)": n
           for label, t in turns.items() for i, (mode, n) in enumerate(zip(t["turns"], t["launches"]))},
        "native toy_cnn plain and remat (phase 18)": 2 * buffers["launches"],
        **{f"native AlexNet remat chunks {m} (phase 18)": n for m, n in chunks["launches"].items()},
        **{f"native AlexNet file {m} (phase 18)": r["launches"] for m, r in entry.items()},
    }
    return dict(turns=turns, buffers=buffers, chunks=chunks, entry=entry, launcher=launcher,
                launches=launches)


# ---------------------------------------------------------------- phase 19 --

# the telemetry runs: (label, scan_steps); the profiled update window, which
# lies inside the epoch's one step_stats window, so the window's fence (at
# update 16) is not in the trace
TELEMETRY_RUNS = (("one step per batch", 1), ("replayed", 2))
TELEMETRY_WINDOW = (4, 12)
TELEMETRY_EVERY = 16


def trace_summary(path: str, top: int = 10):
    """The device operations of a Chrome trace written by ``torch.profiler``:
    the ``top`` by total time, how many there are, and the device idle
    share, 1 - (union of the kernels' intervals) / span. The span runs from
    the end of the first traced update's Adam kernel to the end of the last
    one, so the profiler's start (the host blocked while the card drains)
    stays out; ``idle_share_whole`` is the same over the first device op's
    start to the last one's end. Not measured where the trace holds none."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    launches = sum(1 for e in events if e.get("ph") == "X" and e.get("name") in ("cudaGraphLaunch",))
    if not device:
        return {"device_ops": 0, "graph_launches": launches, "idle_share": "not measured",
                "idle_share_whole": "not measured"}
    totals = {}
    for e in device:
        totals[e["name"]] = totals.get(e["name"], 0.0) + float(e["dur"])
    kernels = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device if e["cat"] == "kernel"])
    start = min(float(e["ts"]) for e in device)
    end = max(float(e["ts"]) + float(e["dur"]) for e in device)
    busy = sum(b - a for a, b in kernels)
    adam_ends = sorted(float(e["ts"]) + float(e["dur"]) for e in device if "fused_adam" in e["name"])
    steady = {"idle_share": "not measured", "steady_updates": max(len(adam_ends) - 1, 0)}
    if len(adam_ends) > 1:
        a, b = adam_ends[0], adam_ends[-1]
        steady_busy = sum(max(0.0, min(y, b) - max(x, a)) for x, y in kernels)
        steady.update(steady_span_ms=(b - a) / 1e3, steady_busy_ms=steady_busy / 1e3,
                      idle_share=1.0 - steady_busy / (b - a))
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": len(device), "kernels": sum(1 for e in device if e["cat"] == "kernel"),
            "graph_launches": launches, "span_ms": (end - start) / 1e3, "kernel_busy_ms": busy / 1e3,
            "idle_share_whole": 1.0 - busy / (end - start), **steady,
            "top": [{"name": n[:120], "ms": t / 1e3, "share_of_span": t / (end - start)} for n, t in ranked]}


def telemetry_run(label: str, scan_steps: int, root: str, plain):
    """19: ``cifar10_alexnet_h100.yaml`` one epoch through the entry point's
    worker with ``step_stats_every: 16`` and ``$TPUDDP_PROFILE_STEPS=4:12``:
    the history valid under the port's validator, its header, the epoch
    row's percentiles and MFU, the step_stats window, and the trace. The
    losses against phase 18's plain run of the same file (`plain`, telemetry
    off): bitwise one step per batch, shown for the replayed run."""
    from tpuddp_torch.observability import profiling, schema

    save_dir = os.path.join(root, f"scan_{scan_steps}")
    os.environ["TPUDDP_PROFILE_STEPS"] = "{}:{}".format(*TELEMETRY_WINDOW)
    try:
        profiling.reset_profiling_state()
        history, wall_s, launches = native_run(
            SETTINGS, {"scan_steps": scan_steps, "step_stats_every": TELEMETRY_EVERY}, save_dir=save_dir)
    finally:
        del os.environ["TPUDDP_PROFILE_STEPS"]
    path = os.path.join(save_dir, "history.jsonl")
    errors, n = schema.validate_history_file(path)
    with open(path) as f:
        records = [json.loads(line) for line in f]
    header, row = records[0], history[0]
    windows = [r for r in records if r["type"] == "step_stats"]
    events = [r for r in records if r["type"] == "event" and r["event"] == "profile"]
    trace = events[0]["path"] if events else None
    checks = {
        "history valid (port validator)": not errors,
        "run_meta header first, device_kind the card's": header["type"] == "run_meta"
        and header["device_kind"] == torch.cuda.get_device_name(0),
        "1 step_stats window of 16": [w["steps"] for w in windows] == [TELEMETRY_EVERY],
        "one profile event naming its trace": len(events) == 1 and os.path.exists(trace),
        "16 Adam launches": launches[fused_adam.kernel.symbol] == 16,
    }
    same = all(row[k] == plain[k] for k in ("train_loss", "test_loss"))
    if scan_steps == 1:
        checks["losses bitwise phase 18's plain run (telemetry off)"] = same
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 19 telemetry {label} failed {failed}: errors {errors}, records "
                         f"{[r['type'] for r in records]}, events {events}")
    summary = trace_summary(trace)
    fields = {k: row[k] for k in ("step_time_ms_p50", "step_time_ms_p95", "step_time_ms_p99",
                                  "step_time_ms_max", "mfu_p50", "mfu_p95", "train_samples_per_sec")}
    phase("19 telemetry", f"AlexNet@224 b128 float32, one epoch {label} (scan_steps {scan_steps}), "
          f"step_stats_every {TELEMETRY_EVERY}, TPUDDP_PROFILE_STEPS={TELEMETRY_WINDOW[0]}:"
          f"{TELEMETRY_WINDOW[1]}: {n} records valid; device_kind {header['device_kind']!r}; epoch row "
          f"{json.dumps(fields)}; windows " + "; ".join(
              f"[{w['step_start']}, +{w['steps']}) p50 {w['step_time_ms_p50']} ms, {w['samples_per_sec']} "
              f"img/s, host stall {w['host_stall_ms']} ms" for w in windows)
          + f"; train_loss {row['train_loss']!r} test_loss {row['test_loss']!r} "
          f"({'bitwise' if same else 'not bitwise'} phase 18's plain run, telemetry off)"
          + f"; trace {os.path.basename(trace)}: {summary['device_ops']} device ops, "
          f"{summary['graph_launches']} cudaGraphLaunch, idle share {summary['idle_share']} over "
          f"{summary['steady_updates']} updates (Adam end to Adam end), {summary['idle_share_whole']} "
          f"over the whole trace")
    if summary.get("top"):
        phase("19 device time", f"{label}, updates [{TELEMETRY_WINDOW[0]}, {TELEMETRY_WINDOW[1]}): span "
              f"{summary['span_ms']:.3f} ms, kernels busy {summary['kernel_busy_ms']:.3f} ms"
              + (f"; steady span {summary['steady_span_ms']:.3f} ms, busy {summary['steady_busy_ms']:.3f} ms"
                 if "steady_span_ms" in summary else "") + "; top 10: " + "; ".join(
                  f"{t['name'][:60]} {t['ms']:.3f} ms ({100 * t['share_of_span']:.1f}%)" for t in summary["top"]))
    return dict(header_device_kind=header["device_kind"], records=n, epoch=fields,
                losses_bitwise_plain=same,
                windows=[{k: w[k] for k in ("step_start", "steps", "step_time_ms_p50", "step_time_ms_p95",
                                            "samples_per_sec", "host_stall_ms", "staging_queue_depth",
                                            "inflight_depth")} for w in windows],
                trace=summary, launches=launches[fused_adam.kernel.symbol], wall_s=wall_s)


def telemetry_phase(plain):
    """Phase 19: the telemetry runs (one step per batch, replayed), held
    against phase 18's plain run of the same file (`plain`)."""
    root = tempfile.mkdtemp(prefix="tpuddp_torch_telemetry_")
    try:
        runs = {label: telemetry_run(label, k, root, plain) for label, k in TELEMETRY_RUNS}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(runs=runs, launches={f"native AlexNet telemetry {label} (phase 19)": r["launches"]
                                     for label, r in runs.items()})


# ---------------------------------------------------------------- phase 20 --

# the step snapshots of phase 20: every 4 real micro-batches, one held at a
# time (a 685 MB write takes seconds on the card's host: the rest are
# skipped, and fewer writes keep the phase short); its dispatches (chunks
# of 4, replayed from the second) and the global train micro-batch of the
# injected preempt
PREEMPT_SNAP = {"every_steps": 4, "inflight": 1}
PREEMPT_RUN = {"scan_steps": 4, "snapshot": PREEMPT_SNAP, "keep_last": 2}
# (a rank's 7th micro-batch: the drain lands after the first chunk, at the
# step of the first snapshot, which the drain's flush has then published)
PREEMPT_STEP = 6
PREEMPT_GRACE_S = 25.0  # the drain's default grace ($TPUDDP_PREEMPT_GRACE)
# the turns without snapshots have no save directory; two turns, not four, to
# leave the script's time to phase 21
SNAPSHOT_TURNS = ("off", "on")
# the SIGTERM run: 64 steps an epoch (over a second one step per batch), the
# signal this long after epoch 0's banner
SIGTERM_N = [8192, 512]
SIGTERM_AFTER_S = 1.0
# the entry point in a process of its own: main() as `python -m
# tpuddp_torch.train_native` runs it, its Adam launches printed however it
# ends (the drain ends it with SystemExit(75))
SIGTERM_SCRIPT = (
    "import json, sys\n"
    "from tpuddp_torch import train_native\n"
    "from tpuddp_torch.ops import fused_adam\n"
    "try:\n"
    "    train_native.main(['--settings_file', sys.argv[1]])\n"
    "finally:\n"
    "    print('LAUNCHES ' + json.dumps({k.symbol: k.launches for k in fused_adam.kernels.values()}),\n"
    "          flush=True)\n"
)


def _with_env(env: dict, fn):
    """``fn()`` with ``env`` set (the fault spec re-read), then put back."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    faults.reload_faults()
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        faults.reload_faults()


def _drained(fn):
    """``fn()`` that the drain ends: ``(exit code, seconds)``; the flag is
    cleared after (else the grace failsafe would end this process)."""
    t0 = time.perf_counter()
    code = 0
    try:
        fn()
    except SystemExit as e:
        code = e.code
    finally:
        preemption.reset_preemption()
    return code, time.perf_counter() - t0


def _step_files(d: str, prefix: str):
    return sorted((f for f in os.listdir(d) if f.startswith(f"{prefix}_0_s") and f.endswith(".npz")),
                  key=lambda f: int(f[len(prefix) + 4:-4]))


def _flight(d: str, reason: str):
    """``d``'s ``flightrec_<reason>.json`` (host 0's) and its errors under
    the port's validator (``({}, [...])`` when there is none)."""
    from tpuddp_torch.observability import schema

    path = os.path.join(d, f"flightrec_{reason}.json")
    if not os.path.exists(path):
        return {}, [f"no {os.path.basename(path)}"]
    errors, _ = schema.validate_flight_file(path)
    with open(path) as f:
        return json.load(f), errors


def _flight_notes(payload: dict) -> dict:
    """A recording's notes but the paths, and its rings' counts."""
    notes = {k: v for k, v in (payload.get("notes") or {}).items() if k != "emergency_checkpoint"}
    return {**notes, "counts": payload.get("counts"), "reason": payload.get("reason")}


def preempt_cycle(kind: str, root: str):
    """20 for one path: the epoch straight (without snapshots: they change
    nothing a run computes, which the snapshot turns hold, and each is a
    685 MB write); the same run with snapshots every 4 steps and
    ``$TPUDDP_FAULT=preempt@step=6``, which must exit 75
    with a step snapshot carrying the v4 cursor; the ``$TPUDDP_AUTO_RESUME=1``
    rerun, whose epoch row and epoch file must be bitwise the straight
    run's; one Adam launch per update in each run."""
    native = kind == "native"
    prefix = "ckpt" if native else "state"
    path = SETTINGS if native else SETTINGS_MANAGED
    worker = basic_ddp_training_loop if native else basic_accelerate_training
    straight, cut = os.path.join(root, f"{kind}_straight"), os.path.join(root, f"{kind}_cut")

    def run(save_dir, snapshot=True):
        settings, training = training_for(path)
        training.update(PREEMPT_RUN)
        if not snapshot:
            training["snapshot"] = None
        reset_counts()
        history = run_ddp_training(partial(worker, training=training, device="cuda"), 1, save_dir,
                                   cfg_lib.optional_args_from(settings), backend="cuda")
        torch.cuda.synchronize()
        return history, fused_adam.kernel.launches

    t0 = time.perf_counter()
    whole, l_whole = run(straight, snapshot=False)
    straight_s = time.perf_counter() - t0
    code, drain_s = _drained(lambda: _with_env({"TPUDDP_FAULT": f"preempt@step={PREEMPT_STEP}"},
                                               lambda: run(cut)))
    l_cut = fused_adam.kernel.launches
    snaps = _step_files(cut, prefix)
    newest = os.path.join(cut, snaps[-1]) if snaps else None
    cursor = ckpt.read_cursor(newest) if newest else None
    intact = newest is not None and ckpt.verify_file(newest)  # before the resume prunes it
    t0 = time.perf_counter()
    again, l_again = _with_env({"TPUDDP_AUTO_RESUME": "1"}, lambda: run(cut))
    resumed_s = time.perf_counter() - t0
    equal, _ = _file_compare(os.path.join(straight, f"{prefix}_0.npz"),
                             os.path.join(cut, f"{prefix}_0.npz"))
    step = int(cursor["step"]) if cursor else -1
    flight, flight_errors = _flight(cut, "preempt")
    keys = ("train_loss", "test_loss", "test_accuracy", "train_samples")
    checks = {
        "exit 75": code == 75,
        "a step snapshot with a v4 cursor (epoch 0, 0 < step < 16, plan key)": cursor is not None
        and cursor["epoch"] == 0 and 0 < step < 16 and bool(cursor.get("plan_key")) and intact,
        "resumed epoch row bitwise the straight run's": [[r[k] for k in keys] for r in again] == [
            [r[k] for k in keys] for r in whole],
        f"{prefix}_0.npz bitwise the straight run's": equal,
        "one Adam launch per update (16 straight, step cut, 16 - step resumed)": (
            l_whole, l_cut, l_again) == (16, step, 16 - step),
        "flightrec_preempt.json valid, its preempt row and steps the drain's": not flight_errors
        and [e["event"] for e in flight["records"]["event"]] == ["preempt"]
        and flight["notes"]["emergency_step"] == flight["records"]["event"][0]["step"] == step
        and flight["notes"]["snapshot_final_step"] == step,
    }
    if native:
        checks["the epoch at 2.9944 / 2.3076"] = (
            round(whole[0]["train_loss"], 4), round(whole[0]["test_loss"], 4)) == F32_LOSSES
        checks["the recording's flushed step the snapshot's"] = (
            flight.get("notes", {}).get("snapshot_flushed_step") == step)
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 20 preempt {kind} failed {failed}: exit {code}, files "
                         f"{sorted(os.listdir(cut))}, cursor {cursor}, launches {(l_whole, l_cut, l_again)}, "
                         f"flight {flight_errors[:5]} {flight.get('notes')}, straight {whole}, "
                         f"resumed {again}")
    acc = {k: np.asarray(v).tolist() for k, v in (cursor.get("acc") or {}).items() if k != "['losses']"}
    phase("20 preempt", f"{kind} AlexNet@224 b128 float32, scan_steps 4, snapshot every 4 steps: "
          f"preempt@step={PREEMPT_STEP} exit {code} after {drain_s:.2f} s, {snaps[-1]} (cursor step "
          f"{step}, plan key {cursor['plan_key']}, acc {acc}); auto-resume continued at step {step}: "
          f"train_loss {again[0]['train_loss']!r} test_loss {again[0]['test_loss']!r} bitwise the straight "
          f"run's, {prefix}_0.npz bitwise; Adam launches straight/cut/resumed {l_whole}/{l_cut}/{l_again}; "
          f"flightrec_preempt.json notes {json.dumps(_flight_notes(flight))}; "
          f"straight run {straight_s:.2f} s, resumed run {resumed_s:.2f} s")
    shutil.rmtree(straight, ignore_errors=True)
    shutil.rmtree(cut, ignore_errors=True)
    return dict(exit=code, drain_s=drain_s, cursor_step=step, file=snaps[-1], acc=acc,
                straight_s=straight_s, resumed_s=resumed_s, flight_notes=_flight_notes(flight),
                losses={k: again[0][k] for k in ("train_loss", "test_loss")},
                launches={f"{kind} straight (phase 20)": l_whole,
                          f"{kind} preempted (phase 20)": l_cut, f"{kind} resumed (phase 20)": l_again})


def sigterm_run(root: str, started: threading.Event = None):
    """20 SIGTERM: ``cifar10_alexnet_h100.yaml`` through ``python -m
    tpuddp_torch.train_native``'s ``main`` in a process of its own (3
    synthetic epochs of 64 steps, one step per batch, snapshots every 4
    steps); :data:`SIGTERM_AFTER_S` after epoch 0's banner the script sends
    SIGTERM; the process must exit 75 within the grace with an intact step
    snapshot written for the drain and a ``preempt`` event row. ``started``
    is set once the process is launched (its environment copied)."""
    settings = cfg_lib.load_settings(SETTINGS)
    d = os.path.join(root, "sigterm")
    os.makedirs(d)
    settings["out_dir"] = d
    settings["training"].update(num_epochs=3, dataset="synthetic", synthetic_n=SIGTERM_N,
                                scan_steps=1, snapshot=PREEMPT_SNAP, keep_last=2)
    steps = SIGTERM_N[0] // settings["training"]["train_batch_size"]
    yaml_path = os.path.join(root, "sigterm.yaml")
    with open(yaml_path, "w") as f:
        json.dump(settings, f)  # JSON is YAML
    env = dict(os.environ, PYTHONPATH=ROOT)
    for var in ("TPUDDP_FAULT", "TPUDDP_AUTO_RESUME", "TPUDDP_WORLD_SIZE"):
        env.pop(var, None)
    t0 = time.perf_counter()
    p = subprocess.Popen([sys.executable, "-u", "-c", SIGTERM_SCRIPT, yaml_path], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if started is not None:
        started.set()
    watchdog = threading.Timer(300, p.kill)
    watchdog.start()
    lines, t_sig = [], None
    try:
        for line in p.stdout:  # the epoch banners stream as the run goes
            lines.append(line)
            if t_sig is None and line.startswith("Process 0, Epoch 0"):
                time.sleep(SIGTERM_AFTER_S)
                t_sig = time.perf_counter()
                p.send_signal(signal.SIGTERM)
        p.wait(timeout=PREEMPT_GRACE_S + 60)
        exit_s = time.perf_counter() - (t_sig or t0)
    finally:
        watchdog.cancel()
        if p.poll() is None:
            p.kill()
            p.wait()
    stdout = "".join(lines)
    if t_sig is None:
        raise SystemExit(f"chip_smoke: 20 SIGTERM: no epoch-0 banner before exit {p.returncode}: "
                         f"{stdout[-3000:]}")
    with open(os.path.join(d, "history.jsonl")) as f:
        records = [json.loads(line) for line in f]
    events = [r for r in records if r["type"] == "event" and r["event"] == "preempt"]
    ev = events[0] if events else {}
    written = (f"ckpt_{ev.get('epoch')}_s{ev['snapshot_step']}.npz" if ev.get("snapshot_step")
               else f"ckpt_{ev.get('epoch')}.npz")
    launches = json.loads(stdout.split("LAUNCHES ", 1)[1].splitlines()[0]) if "LAUNCHES " in stdout else {}
    epochs = [r["epoch"] for r in records if r["type"] == "epoch"]
    checks = {
        "exit 75": p.returncode == 75,
        f"within the {PREEMPT_GRACE_S:.0f} s grace": exit_s < PREEMPT_GRACE_S,
        "one preempt event row, inside epoch 0": len(events) == 1 and ev["epoch"] == 0
        and 0 < (ev.get("snapshot_step") or 0) < steps,
        "the drain's step snapshot intact": ckpt.verify_file(os.path.join(d, written)),
        "one Adam launch per update": launches.get(fused_adam.kernel.symbol)
        == steps * len(epochs) + (ev.get("snapshot_step") or 0),
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 20 SIGTERM failed {failed}: exit {p.returncode} after {exit_s:.2f} s, "
                         f"written {written}, events {events}, launches {launches}: {stdout[-3000:]}")
    phase("20 SIGTERM", f"python -m tpuddp_torch.train_native (cifar10_alexnet_h100.yaml, 3 synthetic epochs "
          f"of {steps} steps, scan_steps 1, snapshot every 4, one held): SIGTERM {SIGTERM_AFTER_S} s after "
          f"epoch 0's banner, {t_sig - t0:.2f} s after the start; exit {p.returncode} {exit_s:.2f} s later "
          f"(grace {PREEMPT_GRACE_S:.0f} s); the drain wrote {written} (epoch {ev['epoch']}, step "
          f"{ev.get('snapshot_step')}); Adam launches "
          f"{launches.get(fused_adam.kernel.symbol)}")
    return dict(exit=p.returncode, exit_s=exit_s, written=written, event=ev, epochs_done=len(epochs),
                launches=launches.get(fused_adam.kernel.symbol))


def snapshot_turns(root: str):
    """20 turns: ``cifar10_alexnet_h100.yaml`` two epochs at scan_steps 4,
    snapshots (:data:`PREEMPT_SNAP`) off and on in turns (:data:`SNAPSHOT_TURNS`):
    every run's rows bitwise the first's; epoch 2's step median; for the
    runs with snapshots, those written, skipped (a full engine), the
    writer's seconds and the loop's seconds in the engine (its host stall)
    per step."""
    runs = []
    for i, mode in enumerate(SNAPSHOT_TURNS):
        d = os.path.join(root, f"turn{i}_{mode}")
        on = mode == "on"
        overrides = dict(PREEMPT_RUN, num_epochs=1, snapshot=PREEMPT_SNAP if on else None)
        real_save = ckpt.save_on_main
        # the epoch-end save is not what the turns measure (a 685 MB write
        # the off turn, with no save directory, does not make)
        ckpt.save_on_main = lambda save_dir, epoch, model, optimizer, *a, **k: None
        try:
            history, wall_s, launches = native_run(SETTINGS, overrides, save_dir=d if on else None)
        finally:
            ckpt.save_on_main = real_save
        # the writer's statistics once every write has landed: the newest sidecar
        sidecars = [json.load(open(os.path.join(d, f))) for f in os.listdir(d)
                    if f.endswith(".writer.json")] if on else []
        snap = max(sidecars, key=lambda w: (w["snapshots"], w["skipped_queue_full"]), default={})
        shutil.rmtree(d, ignore_errors=True)
        runs.append(dict(mode=mode, wall_s=wall_s, launches=launches[fused_adam.kernel.symbol],
                         step_ms_median=statistics.median(history[0]["step_ms"]),
                         rows=[[r[k] for k in ("train_loss", "test_loss")] for r in history],
                         snapshots=snap.get("snapshots"), skipped=snap.get("skipped_queue_full"),
                         write_s=snap.get("write_s"),
                         host_ms_per_step=None if not snap else snap["host_s"] * 1e3 / 16))
    checks = {
        "every turn's rows bitwise the first's": all(r["rows"] == runs[0]["rows"] for r in runs),
        "16 Adam launches a run": all(r["launches"] == 16 for r in runs),
        "snapshots written where on": all((r["snapshots"] or 0) > 0 for r in runs if r["mode"] == "on"),
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 20 snapshot turns failed {failed}: {runs}")
    phase("20 snapshot turns", "cifar10_alexnet_h100.yaml 1 epoch at scan_steps 4, snapshots every 4 "
          "steps (one held at a time) off/on in turns: " + "; ".join(
              f"{r['mode']} step median {r['step_ms_median']:.3f} ms" + (
                  f" ({r['snapshots']} written, {r['skipped']} skipped, writer {r['write_s']:.2f} s, "
                  f"loop {r['host_ms_per_step']:.3f} ms/step in the engine)" if r["mode"] == "on" else "")
              + f", wall {r['wall_s']:.2f} s" for r in runs) + "; rows bitwise across turns")
    return dict(turns=runs, launches={f"native snapshot turn {i} {r['mode']} (phase 20)": r["launches"]
                                      for i, r in enumerate(runs)})


def preempt_phase():
    """Phase 20: the drain and the step snapshots (native and managed cycles,
    the real SIGTERM, snapshots off/on in turns). The SIGTERM process runs
    beside the cycles (most of its time is its start; the card holds both)."""
    root = tempfile.mkdtemp(prefix="tpuddp_torch_preempt_")
    try:
        started, sig = threading.Event(), {}

        def sigterm():
            try:
                sig["out"] = sigterm_run(root, started)
            except BaseException as e:  # noqa: BLE001 — raised again on this thread
                sig["error"] = e
                started.set()

        side = threading.Thread(target=sigterm, name="chip-smoke-sigterm", daemon=True)
        side.start()
        started.wait()
        cycles = {kind: preempt_cycle(kind, root) for kind in ("native", "managed")}
        side.join()
        if "error" in sig:
            raise sig["error"]
        sig = sig["out"]
        turns = snapshot_turns(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {k: n for c in cycles.values() for k, n in c["launches"].items()}
    launches.update(turns["launches"])
    return dict(cycles={k: {f: v for f, v in c.items() if f != "launches"} for k, c in cycles.items()},
                sigterm=sig, turns=turns["turns"], launches=launches)


# ---------------------------------------------------------------- phase 21 --

# the elastic restart on multihost_h100.yaml cut to 2 synthetic epochs
# (2048 / 512 images: 8 steps an epoch at world 2, 16 at world 1) with
# bf16_ef. The watchdog's timeout; the slack past it that host 0's exit may
# take after the hang (the watchdog reads the beats every timeout / 4 = 1.25
# s, a beat lands every 1 s, then the event row's fsync and the process's
# exit); the supervised crash's micro-batch, counted from the resumed loop's
# entry (the 6th of epoch 1); the time limit of each part
ELASTIC_TIMEOUT_S = 5.0
ELASTIC_SLACK_S = 5.0
ELASTIC_CRASH_STEP = 5
ELASTIC_S = 300
# a host of the hung pair: the entry point's main, every log line stamped
# with its wall time (the hang's moment)
ELASTIC_HOST_SCRIPT = (
    "import logging, sys\n"
    "logging.basicConfig(level=logging.INFO, format='%(created).6f %(message)s')\n"
    "from tpuddp_torch import train_native\n"
    "train_native.main(['--settings_file', sys.argv[1]])\n"
)
# the supervised command: the entry point's main with its arguments, its
# start time and, however it ends but os._exit, its Adam launches printed
ELASTIC_CHILD_SCRIPT = (
    "import json, sys, time\n"
    "print(f'START {time.time():.6f}', flush=True)\n"
    "from tpuddp_torch import train_native\n"
    "from tpuddp_torch.ops import fused_adam\n"
    "try:\n"
    "    train_native.main(sys.argv[1:])\n"
    "finally:\n"
    "    print('LAUNCHES ' + json.dumps({k.symbol: k.launches for k in fused_adam.kernels.values()}),\n"
    "          flush=True)\n"
)


def _elastic_settings():
    """multihost_h100.yaml cut for phase 21 (seeded: the file has no seed)."""
    settings = json.loads(json.dumps(cfg_lib.load_settings(SETTINGS_MULTIHOST)))
    settings["training"].update(num_epochs=2, checkpoint_epoch=1, dataset="synthetic",
                                synthetic_n=[2048, 512], scan_steps=1, seed=0, comm_hook="bf16_ef")
    return settings


def _records(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def elastic_hang(root: str):
    """21 watchdog: two host processes over Gloo on this card (as phase 17)
    sharing one out_dir, ``$TPUDDP_WATCHDOG_TIMEOUT`` on both and
    ``hang@epoch=1`` on host 1: host 0 exits 76 within the timeout and the
    slack after host 1's hang, its history holds a ``watchdog_stale`` row
    naming process 1, and ``ckpt_0.npz`` holds a world-2 per-replica
    residual. Host 1 is killed after. Returns the out_dir and the numbers."""
    settings = _elastic_settings()
    settings["local"]["rendezvous"]["coordinator_address"] = f"127.0.0.1:{_free_ports(1)[0]}"
    out = os.path.join(root, "run")
    os.makedirs(out)
    path = os.path.join(root, "hosts.yaml")
    with open(path, "w") as f:
        json.dump(dict(settings, out_dir=out), f)  # JSON is YAML
    procs, logs = [], []
    try:
        for pid in (0, 1):
            env = dict(os.environ, TPUDDP_BACKEND="gloo", TPUDDP_PROCESS_ID=str(pid),
                       TPUDDP_WORLD_SIZE="2", PYTHONPATH=ROOT,
                       TPUDDP_WATCHDOG_TIMEOUT=str(ELASTIC_TIMEOUT_S))
            for var in ("TPUDDP_COORDINATOR", "TPUDDP_NUM_PROCESSES", "TPUDDP_FAULT",
                        "TPUDDP_AUTO_RESUME", "TPUDDP_HEARTBEAT_DIR"):
                env.pop(var, None)
            if pid == 1:
                env["TPUDDP_FAULT"] = "hang@epoch=1"
            logs.append(open(os.path.join(root, f"host{pid}.log"), "w+"))
            procs.append(subprocess.Popen([sys.executable, "-c", ELASTIC_HOST_SCRIPT, path], cwd=ROOT,
                                          env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        t0 = time.time()
        try:
            rc0 = procs[0].wait(timeout=ELASTIC_S)
        except subprocess.TimeoutExpired:
            rc0 = None
        t_exit = time.time()
        host1_alive = procs[1].poll() is None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    hung = [float(line.split()[0]) for line in texts[1].splitlines()
            if "fault injection: hang@epoch fired" in line]
    detect_s = t_exit - hung[0] if hung else math.inf
    records = _records(os.path.join(out, "history.jsonl"))
    stale = [r for r in records if r.get("event") == "watchdog_stale"]
    topo = ckpt.read_topology(os.path.join(out, "ckpt_0.npz"))
    residual_tag = ((topo or {}).get("leaves") or {}).get(".comm_state") or {}
    epoch_0 = [r for r in records if r["type"] == "epoch"]
    flight, flight_errors = _flight(out, "watchdog")
    checks = {
        "host 0's flightrec_watchdog.json valid, holding epoch 0's row": not flight_errors
        and flight["reason"] == "watchdog" and flight["process_index"] == 0
        and [r["epoch"] for r in flight["records"]["epoch"]] == [0]
        and flight["run_meta"]["observability"]["flight_recorder"] == {"capacity": 64},
        "host 0 exits 76": rc0 == 76,
        "host 1 hung (alive, its hang logged) when host 0 exited": host1_alive and bool(hung),
        f"host 0 out within {ELASTIC_TIMEOUT_S} + {ELASTIC_SLACK_S} s of the hang":
            detect_s <= ELASTIC_TIMEOUT_S + ELASTIC_SLACK_S,
        "a watchdog_stale row naming process 1, lag_s >= the timeout": len(stale) == 1 and (
            stale[0]["process"] == 0 and [p["process"] for p in stale[0]["stale_peers"]] == [1]
            and stale[0]["stale_peers"][0]["lag_s"] >= ELASTIC_TIMEOUT_S),
        "ckpt_0.npz's residual per_replica at world 2": residual_tag.get("kind") == "per_replica"
        and residual_tag.get("world") == 2 and (topo or {}).get("world_size") == 2,
        "epoch 0 trained at world 2": [(r["epoch"], r["world_size"]) for r in epoch_0] == [(0, 2)],
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 21 watchdog: failed {failed}; rc0 {rc0}, detect {detect_s} s, "
                         f"stale {stale}, topology {topo}, flight {flight_errors[:5]} "
                         f"{_flight_notes(flight)}\nhost 0:\n{texts[0][-3000:]}\n"
                         f"host 1:\n{texts[1][-3000:]}")
    phase("21 watchdog", f"multihost_h100.yaml 2 synthetic epochs bf16_ef, world 2 = 2 hosts over Gloo "
          f"on one card, $TPUDDP_WATCHDOG_TIMEOUT={ELASTIC_TIMEOUT_S:g}, hang@epoch=1 on host 1: host 0 "
          f"exit {rc0} {detect_s:.2f} s after the hang (limit {ELASTIC_TIMEOUT_S + ELASTIC_SLACK_S:g}), "
          f"stale lag {stale[0]['stale_peers'][0]['lag_s']} s; pair's wall {t_exit - t0:.1f} s; epoch 0 "
          f"losses {epoch_0[0]['train_loss']:.4f}/{epoch_0[0]['test_loss']:.4f}; host 0 dumped "
          f"flightrec_watchdog.json ({json.dumps(_flight_notes(flight))})")
    return out, dict(rc_host0=rc0, detect_s=detect_s, stale=stale[0], wall_s=t_exit - t0,
                     epoch_0=[epoch_0[0]["train_loss"], epoch_0[0]["test_loss"]],
                     flight=_flight_notes(flight))


def elastic_restore_check(out: str, training: dict):
    """The port's restore of the hung pair's ``ckpt_0.npz`` at world 1 on
    the card, in this process: the residual bitwise the float32 sum of the
    file's two rows, one ``topology_change`` (2 -> 1, redistributed)."""
    ddp, *_ = build_training(0, 1, training, "cuda")
    log = []
    ckpt.restore_latest(out, ddp.model, ddp.optimizer, comm_state=ddp.residual, reshard_log=log)
    got = ddp.residual.cpu().numpy()
    rows = _arrays(os.path.join(out, "ckpt_0.npz"))[".comm_state"].reshape(2, -1)
    summed = rows[0] + rows[1]  # float32
    per = got.size
    ok = (np.array_equal(got, summed[:per]) and not np.any(summed[per:])
          and np.any(rows[0] != 0) and np.any(rows[1] != 0))
    events = [(e["event"], e["from_world"], e["to_world"], e["residual"]) for e in log]
    del ddp
    gc.collect()
    torch.cuda.empty_cache()
    if not ok or events != [("topology_change", 2, 1, "redistributed")]:
        raise SystemExit(f"chip_smoke: 21 restore: residual bitwise the rows' sum {ok}, events {events}")
    return dict(elements=per, max_abs=float(np.abs(got).max()), events=events)


def elastic_supervised(root: str, out: str):
    """21 supervisor: ``python -m tpuddp_torch.supervise --world 1`` over the
    entry point on the hung pair's out_dir without its rendezvous (one
    process on the card), ``$TPUDDP_AUTO_RESUME=1`` on the first attempt
    too and ``crash@step=5`` on it alone: attempt 0 resumes ckpt_0.npz at
    world 1 and exits 113, attempt 1 resumes it again and exits 0; a
    ``topology_change`` (2 -> 1, redistributed) per attempt; attempt 1's
    Adam launches equal its updates times the tables."""
    from tpuddp_torch.observability import schema

    settings = _elastic_settings()
    settings["local"].pop("rendezvous")
    settings["local"].update(device="cuda", gpu={"num_gpus": 1})
    path = os.path.join(root, "single.yaml")
    with open(path, "w") as f:
        json.dump(dict(settings, out_dir=out), f)
    restore = elastic_restore_check(out, cfg_lib.training_config(settings))
    env = dict(os.environ, PYTHONPATH=ROOT, TPUDDP_AUTO_RESUME="1")
    for var in ("TPUDDP_BACKEND", "TPUDDP_PROCESS_ID", "TPUDDP_COORDINATOR", "TPUDDP_NUM_PROCESSES",
                "TPUDDP_FAULT", "TPUDDP_WATCHDOG_TIMEOUT", "TPUDDP_WORLD_SIZE"):
        env.pop(var, None)
    cmd = [sys.executable, "-m", "tpuddp_torch.supervise", "--world", "1", "--backoff-base", "0.1",
           "--first-env", f"TPUDDP_FAULT=crash@step={ELASTIC_CRASH_STEP}", "--flight-dir", out, "--",
           sys.executable, "-c", ELASTIC_CHILD_SCRIPT, "--settings_file", path]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    timer = threading.Timer(ELASTIC_S, proc.kill)
    timer.start()
    lines = []
    try:
        for line in proc.stdout:  # each line stamped as it arrives
            lines.append((time.time(), line.rstrip("\n")))
        rc = proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    # the supervisor's trail from its lines: each attempt's start (the
    # child's stamp), its exit code and the moment the supervisor read it
    starts = [float(l.split()[1]) for _, l in lines if l.startswith("START ")]
    ends = []
    for t, l in lines:
        if l.startswith("supervisor: child exited "):
            ends.append((int(l.split()[3].rstrip(";")), t))
        elif l.startswith("supervisor: child finished cleanly"):
            ends.append((0, t))
    records = _records(os.path.join(out, "history.jsonl"))
    heads = [i for i, r in enumerate(records) if r["type"] == "run_meta"][1:]  # the pair's first
    attempts = [records[a:b] for a, b in zip(heads, heads[1:] + [len(records)])]
    worlds = [a[0]["world_size"] for a in attempts]
    history = [(i, rc_i, w) for i, ((rc_i, _), w) in enumerate(zip(ends, worlds))]
    topo = [[(r["from_world"], r["to_world"], r["residual"], r["checkpoint"]) for r in a
             if r.get("event") == "topology_change"] for a in attempts]
    last_rows = [r for r in attempts[-1] if r["type"] == "epoch"] if attempts else []
    updates = sum(len(r["step_ms"]) for r in last_rows)
    launch_lines = [json.loads(l[len("LAUNCHES "):]) for _, l in lines if l.startswith("LAUNCHES ")]
    f32 = fused_adam.kernel.symbol
    tables = _tables(62)  # resnet18_small's 62 leaves
    wall = [t_end - t_start for t_start, (_, t_end) in zip(starts, ends)]
    text = "\n".join(l for _, l in lines)
    errors, _n = schema.validate_history_file(os.path.join(out, "history.jsonl"))
    checks = {
        "the supervisor exits 0": rc == 0,
        "history [(0, 113, 1), (1, 0, 1)]": history == [(0, 113, 1), (1, 0, 1)],
        "each attempt resumed epoch 1": text.count("Auto-resume: continuing from epoch 1.") == 2,
        "a topology_change 2 -> 1 redistributed from ckpt_0.npz per attempt":
            topo == [[(2, 1, "redistributed", "ckpt_0.npz")]] * 2,
        "the headers say resumed_from_world 2": all(a[0].get("resumed_from_world") == 2
                                                   for a in attempts),
        "attempt 1 trained epoch 1 (16 updates)": [r["epoch"] for r in last_rows] == [1]
        and updates == 16,
        f"{tables} Adam launches per update of attempt 1": len(launch_lines) == 1
        and launch_lines[0][f32] == tables * updates and sum(launch_lines[0].values()) == tables * updates,
        "finite losses": all(math.isfinite(r[k]) for r in last_rows for k in ("train_loss", "test_loss")),
        "the history validates": not errors,
        "the supervisor summarized the watchdog's recording once, before attempt 0": text.count(
            "supervisor: flight recording: reason=watchdog process=0") == 1
        and text.index("supervisor: flight recording: reason=watchdog") < text.index("START "),
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 21 supervisor: failed {failed}; rc {rc}, history {history}, "
                         f"topology {topo}, launches {launch_lines}, errors {errors[:5]}\n{text[-5000:]}")
    phase("21 supervisor", f"python -m tpuddp_torch.supervise --world 1 --backoff-base 0.1 --first-env "
          f"TPUDDP_FAULT=crash@step={ELASTIC_CRASH_STEP} --flight-dir <out_dir> over the entry point "
          f"(the watchdog's recording summarized before attempt 0) on the pair's out_dir at "
          f"world 1 on the card: history {history}, exit {rc}; attempts' wall "
          + ", ".join(f"{w:.1f} s" for w in wall) + f"; restore in this process: residual of "
          f"{restore['elements']} bitwise the float32 sum of the file's 2 rows (max |r| "
          f"{restore['max_abs']:.3g}); attempt 1: {updates} updates, {launch_lines[0][f32]} Adam "
          f"launches, losses {last_rows[0]['train_loss']:.4f}/{last_rows[0]['test_loss']:.4f}")
    return dict(history=history, rc=rc, attempt_wall_s=wall, restore=restore, updates=updates,
                launches=launch_lines[0][f32],
                epoch_1=[last_rows[0]["train_loss"], last_rows[0]["test_loss"]])


def elastic_phase():
    """Phase 21: the elastic restart (the watchdog, the supervisor, a
    residual restored onto another world size)."""
    root = tempfile.mkdtemp(prefix="tpuddp_torch_elastic_")
    try:
        out, hang = elastic_hang(root)
        sup = elastic_supervised(root, out)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase("21 elastic", f"card {card_line()}: host 0 exit {hang['rc_host0']} {hang['detect_s']:.2f} s "
          f"after the hang; supervisor exits {[h[1] for h in sup['history']]}, attempts' wall "
          + ", ".join(f"{w:.1f} s" for w in sup["attempt_wall_s"])
          + f"; losses epoch 0 (world 2) {hang['epoch_0'][0]:.4f}/{hang['epoch_0'][1]:.4f}, epoch 1 "
          f"(world 1, resumed) {sup['epoch_1'][0]:.4f}/{sup['epoch_1'][1]:.4f}")
    return dict(watchdog=hang, supervisor=sup,
                launches={"native elastic supervised attempt 1 (phase 21)": sup["launches"]})


# ---------------------------------------------------------------- phase 22 --

# step snapshots and the agreed drain at world 2 on one host, and mode auto.
# The two ranks of one host are two processes this script starts, each
# calling the port's rank worker (parallel/spawn.py's _worker) as local rank
# 0 of 1 at world 2 against a store this script holds, over Gloo on this
# card (NCCL and the launcher refuse two ranks on one GPU): one host, so the
# engine arms on both and the drain is agreed at every dispatch.
# cifar10_resnet18_small_h100.yaml (configs/multihost.yaml's training block,
# full width) cut to 2 synthetic epochs (1024 images a rank: 8 steps an
# epoch), one step per batch (a CUDA graph cannot hold Gloo), seed 0,
# bf16_ef with ZeRO-1, a step snapshot every 4 steps
SNAP22 = {"every_steps": 4}
RUN22 = dict(num_epochs=2, checkpoint_epoch=1, dataset="synthetic", synthetic_n=[2048, 512],
             scan_steps=1, seed=0, comm_hook="bf16_ef", weight_update_sharding=True,
             snapshot=SNAP22)
# the drain's micro-batch: a rank's 12th, epoch 1's 4th (staged ahead of its step)
PREEMPT22_STEP = 12
# the pair's turns in order (label, the training block's overrides, the
# environment): snapshots off, then on in (a) the uninterrupted run; (b)
# the drained one and (c) its resume; the mode auto pair; last, the agreed
# poll alone: POLL22_N exchanges back to back (after POLL22_WARM), with no
# step between them to wait for
TURNS22 = (
    ("off", {"snapshot": None}, {}),
    ("a", {}, {}),
    ("b", {}, {"TPUDDP_FAULT": f"preempt@step={PREEMPT22_STEP}"}),
    ("c", {}, {"TPUDDP_AUTO_RESUME": "1"}),
    ("auto", {"mode": "auto", "comm_hook": "none", "weight_update_sharding": False,
              "snapshot": None}, {}),
    ("poll", None, {}),
)
POLL22_WARM, POLL22_N = 50, 500
PAIR22_S = 600
# one rank of the pair: every turn in order, each through the rank worker
# with the Adam launch counts set to 0 just before it; after it one TURN
# line on stderr, after the loop's closing line there: its exit code, its
# launches, and a sha256 of the rank's parameters at each epoch save (every
# rank takes part in a save)
PAIR22_SCRIPT = (
    "import hashlib, json, os, sys\n"
    "from functools import partial\n"
    "from tpuddp_torch import config as cfg_lib\n"
    "from tpuddp_torch.ops import fused_adam\n"
    "from tpuddp_torch.parallel import backend, spawn\n"
    "from tpuddp_torch.resilience import faults, preemption\n"
    "from tpuddp_torch.train_native import basic_ddp_training_loop\n"
    "from tpuddp_torch.training import checkpoint as ckpt\n"
    "from tpuddp_torch.training.loop import AgreedPoll\n"
    "rank = int(sys.argv[1])\n"
    "with open(sys.argv[2]) as f:\n"
    "    turns = json.load(f)\n"
    "save, digests = ckpt.save_on_main, []\n"
    "def hashed(save_dir, epoch, model, *args, **kwargs):\n"
    "    h = hashlib.sha256()\n"
    "    for p in model.parameters():\n"
    "        h.update(p.detach().cpu().numpy().tobytes())\n"
    "    digests.append(h.hexdigest())\n"
    "    return save(save_dir, epoch, model, *args, **kwargs)\n"
    "ckpt.save_on_main = hashed\n"
    "for turn in turns:\n"
    "    if turn['label'] == 'poll':\n"
    "        backend.setup(rank, 2, 'cuda', turn['port'], local_rank=0, local_world=1)\n"
    "        agreed = AgreedPoll()\n"
    "        for i in range(turn['warm'] + turn['n']):\n"
    "            if i == turn['warm']:\n"
    "                agreed.exchanges, agreed.seconds = 0, 0.0\n"
    "            agreed.exchange()\n"
    "        backend.cleanup()\n"
    "        print('TURN ' + json.dumps({'label': 'poll', 'exit': 0, 'digests': [], 'launches': {},\n"
    "              'exchanges': agreed.exchanges, 'seconds': agreed.seconds}), file=sys.stderr,\n"
    "              flush=True)\n"
    "        continue\n"
    "    os.environ.update(turn['env'])\n"
    "    faults.reload_faults()\n"
    "    for k in fused_adam.kernels.values():\n"
    "        k.reset_launches()\n"
    "    digests.clear()\n"
    "    settings = cfg_lib.load_settings(turn['settings'])\n"
    "    fn = partial(basic_ddp_training_loop, training=cfg_lib.training_config(settings),\n"
    "                 device='cuda')\n"
    "    code = 0\n"
    "    try:\n"
    "        spawn._worker(rank, fn, 2, settings['out_dir'], cfg_lib.optional_args_from(settings),\n"
    "                      'cuda', turn['port'], None, (0, 1))\n"
    "    except SystemExit as e:\n"
    "        code = e.code\n"
    "    preemption.reset_preemption()\n"
    "    for k in turn['env']:\n"
    "        os.environ.pop(k, None)\n"
    "    faults.reload_faults()\n"
    "    print('TURN ' + json.dumps({'label': turn['label'], 'exit': code, 'digests': digests,\n"
    "          'launches': {k.symbol: k.launches for k in fused_adam.kernels.values()}}),\n"
    "          file=sys.stderr, flush=True)\n"
)
# a rank's closing line of a turn on stderr (training/loop.py's _log_drain_stats)
STATS22 = re.compile(r"^rank (\d+); snapshot engine: (\d+) taken, (\d+) written, (\d+) skipped, "
                     r"host_s ([0-9.]+); agreed poll: (\d+) exchanges, ([0-9.]+) ms each$", re.M)
POLL22 = re.compile(r"^rank (\d+); agreed poll: (\d+) exchanges, ([0-9.]+) ms each$", re.M)
# mode auto at world 1 on the card against the CPU: one AlexNet@224 b128
# float32 step (dropout 0: the two devices draw different masks) from one
# seeded state on a seeded batch, no flip: its loss within AUTO22_RTOL
# (float32 convolutions and sums in another order). Its gradient is printed,
# not held: elementwise it parts from the CPU's by up to 2.7% of a leaf's
# largest element on the card (not split). A loss after the update is no
# check either: Adam's first step is about lr * sign(g), which a near-zero
# element flips
AUTO22_RTOL = 1e-4


def _pair_turns(root: str):
    """Write each turn's settings and hold a store for it: the turns, the
    stores (open until the pair ends) and the out_dirs by label."""
    base = cfg_lib.load_settings(SETTINGS_RESNET)
    turns, stores = [], []
    for i, (label, overrides, env) in enumerate(TURNS22):
        stores.append(backend.rendezvous_store(2))
        if label == "poll":
            turns.append(dict(label=label, env={}, port=stores[-1].port, dir=None,
                              warm=POLL22_WARM, n=POLL22_N))
            continue
        settings = json.loads(json.dumps(base))
        settings["training"].update(RUN22)
        settings["training"].update(overrides)
        # (b) and (c) share one out_dir: the resume reads the drain's file
        d = os.path.join(root, "cut" if label in ("b", "c") else f"turn{i}_{label}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(root, f"turn{i}.yaml")
        with open(path, "w") as f:
            json.dump(dict(settings, out_dir=d), f)  # JSON is YAML
        turns.append(dict(label=label, settings=path, env=env, port=stores[-1].port, dir=d))
    return turns, stores


def pair_runs(root: str):
    """Every turn of :data:`TURNS22` in one pair of rank processes: per turn
    each rank's exit code, launches, save digests and closing line, and
    rank 0's epoch rows and preempt events; each rank's stdout; the pair's
    wall seconds."""
    turns, stores = _pair_turns(root)
    path = os.path.join(root, "turns.json")
    with open(path, "w") as f:
        json.dump(turns, f)
    env = dict(os.environ, TPUDDP_BACKEND="gloo", PYTHONPATH=ROOT)
    for var in ("TPUDDP_FAULT", "TPUDDP_AUTO_RESUME", "TPUDDP_WORLD_SIZE", "TPUDDP_COORDINATOR",
                "TPUDDP_NUM_PROCESSES", "TPUDDP_PROCESS_ID"):
        env.pop(var, None)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", PAIR22_SCRIPT, str(rank), path], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PAIR22_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        del stores
    wall_s = time.perf_counter() - t0
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or err.count("TURN ") != len(turns):
            raise SystemExit(f"chip_smoke: 22 pair: rank {rank} exited {p.returncode} after "
                             f"{err.count('TURN ')} of {len(turns)} turns:\n{out[-3000:]}\n{err[-5000:]}")
    for rank, (_, err) in enumerate(outs):
        text = ""
        for line in err.splitlines(keepends=True):
            if not line.startswith("TURN "):
                text += line
                continue
            rec = json.loads(line[5:])
            turn = next(t for t in turns if t["label"] == rec["label"] and rank not in t.get("ranks", {}))
            stats = STATS22.search(text)
            poll = POLL22.search(text)
            if rec["label"] == "poll":
                turn.setdefault("ranks", {})[rank] = dict(
                    exit=rec["exit"], launches=0, others=0, digests=[], stderr=text,
                    poll=dict(exchanges=rec["exchanges"], ms=rec["seconds"] * 1e3 / rec["exchanges"]))
                text = ""
                continue
            turn.setdefault("ranks", {})[rank] = dict(
                exit=rec["exit"], launches=rec["launches"][fused_adam.kernel.symbol],
                others=sum(n for s, n in rec["launches"].items() if s != fused_adam.kernel.symbol),
                digests=rec["digests"], stderr=text,
                snapshots=None if stats is None else dict(
                    taken=int(stats.group(2)), written=int(stats.group(3)),
                    skipped=int(stats.group(4)), engine_s=float(stats.group(5))),
                poll=None if (stats or poll) is None else dict(
                    exchanges=int((stats or poll).group(6 if stats else 2)),
                    ms=float((stats or poll).group(7 if stats else 3))))
            text = ""
    for turn in turns:
        if turn["dir"] is None:
            continue
        records = _records(os.path.join(turn["dir"], "history.jsonl"))
        turn["rows"] = [r for r in records if r["type"] == "epoch"]
        turn["preempts"] = [r for r in records if r.get("event") == "preempt"]
    return turns, [out for out, _ in outs], wall_s


def _rows22(rows):
    return [[r[k] for k in ("epoch", "train_loss", "test_loss", "test_accuracy", "train_samples")]
            for r in rows]


def pair_checks(turns, stdouts):
    """Part A's and the auto pair's checks on the turns and each rank's
    stdout; returns the drained step."""
    by = {}
    for t in turns:
        by.setdefault(t["label"], []).append(t)
    (a,), (b,), (c,), (auto,), (poll,) = by["a"], by["b"], by["c"], by["auto"], by["poll"]
    steps = b["preempts"][0].get("snapshot_step") if len(b["preempts"]) == 1 else None
    a_file, c_file = os.path.join(a["dir"], "ckpt_1.npz"), os.path.join(c["dir"], "ckpt_1.npz")
    fa, fc = _arrays(a_file), _arrays(c_file)
    exits = {t["label"] + str(i): [t["ranks"][r]["exit"] for r in (0, 1)]
             for i, t in enumerate(turns)}
    checks = {
        "(b) exits 75 on both ranks, every other turn 0": all(
            codes == ([75, 75] if label.startswith("b") else [0, 0]) for label, codes in exits.items()),
        "(b) one preempt row, inside epoch 1, with its step snapshot": steps is not None
        and b["preempts"][0]["epoch"] == 1 and 0 < steps < 8,
        "(c) continued epoch 1 at that step": f"Exact resume: epoch 1 continues at step {steps}"
        in stdouts[0],
        "(c)'s epoch rows bitwise (a)'s": _rows22(c["rows"]) == _rows22(a["rows"])
        and len(a["rows"]) == 2,
        "(c)'s ckpt_1.npz bitwise (a)'s": sorted(fa) == sorted(fc)
        and all(np.array_equal(fa[k], fc[k]) for k in fa),
        "(c)'s last parameters (a)'s on both ranks": {c["ranks"][r]["digests"][-1] for r in (0, 1)}
        == {a["ranks"][0]["digests"][-1]},
        "both ranks stopped after the same dispatch (as many agreements)": len(
            {b["ranks"][r]["poll"]["exchanges"] for r in (0, 1)}) == 1,
        "every rank takes the same snapshots, rank 0 writes them": all(
            t["ranks"][0]["snapshots"]["taken"] == t["ranks"][1]["snapshots"]["taken"]
            == t["ranks"][0]["snapshots"]["written"] > 0 and t["ranks"][1]["snapshots"]["written"] == 0
            for t in by["a"]),
        "one Adam launch per ZeRO-1 update on each rank (16; 8 + step; 8 - step)": all(
            t["ranks"][r]["launches"] == 16 and t["ranks"][r]["others"] == 0
            for t in by["off"] + by["a"] for r in (0, 1))
        and [b["ranks"][r]["launches"] for r in (0, 1)] == [8 + (steps or 0)] * 2
        and [c["ranks"][r]["launches"] for r in (0, 1)] == [8 - (steps or 0)] * 2,
        "auto: the ranks' parameters bitwise equal after every epoch": len(
            auto["ranks"][0]["digests"]) == 2 and auto["ranks"][0]["digests"] == auto["ranks"][1]["digests"],
        "auto: finite losses, two tables per update": all(
            math.isfinite(r[k]) for r in auto["rows"] for k in ("train_loss", "test_loss"))
        and all(auto["ranks"][r]["launches"] == 16 * _tables(62) for r in (0, 1)),
        "every turn's ranks hold the same parameters at each save": all(
            t["ranks"][0]["digests"] == t["ranks"][1]["digests"] for t in turns),
        "the poll alone: as many exchanges on both ranks": [
            poll["ranks"][r]["poll"]["exchanges"] for r in (0, 1)] == [POLL22_N] * 2,
    }
    del fa, fc
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 22 pair failed {failed}: exits {exits}, preempts {b['preempts']}, "
                         + "; ".join(f"{t['label']}: rows {_rows22(t['rows'])} ranks "
                                     f"{ {r: {k: v for k, v in d.items() if k != 'stderr'} for r, d in t['ranks'].items()} }"
                                     for t in turns)
                         + f"\nrank 0: {stdouts[0][-3000:]}")
    return steps


def auto_world_1():
    """mode auto at world 1: one epoch of cifar10_alexnet_h100.yaml (16
    updates, one Adam launch each, at the float32 losses 2.9944 / 2.3076:
    at world 1 the global batch is the batch), and one step on the card
    against the CPU from one state."""
    history, wall_s, launches = native_run(SETTINGS, {"mode": "auto"})
    steps = check_epochs("22 mode auto AlexNet", history, launches, fused_adam.kernel, True)
    gen = torch.Generator().manual_seed(22)
    batch = (torch.randint(0, 256, (128, 32, 32, 3), dtype=torch.uint8, generator=gen),
             torch.randint(0, 10, (128,), generator=gen), torch.ones(128))
    torch.manual_seed(0)
    init = AlexNet(num_classes=10, dropout=0.0).state_dict()
    # the same step at mode shard_map (the plain per-replica step) beside it:
    # whether the card parts from the CPU in the gradient for mode auto alone
    parts = {}
    for mode in ("auto", "shard_map"):
        sums, grads = {}, {}
        for dev in ("cuda", "cpu"):
            model = AlexNet(num_classes=10, dropout=0.0)
            model.load_state_dict(init)
            ddp = DistributedDataParallel(model, Adam(model.parameters(), lr=1e-3), CrossEntropyLoss(),
                                          augment=make_train_augment(size=224, flip=False), device=dev,
                                          mode=mode)
            sums[dev] = ddp.train_step(batch).cpu()
            grads[dev] = [p.grad.detach().cpu() for p in ddp.model.parameters()]
        parts[mode] = dict(
            sums=sums, grads=grads,
            loss_rel=float((sums["cuda"][0] - sums["cpu"][0]).abs() / sums["cpu"][0].abs()),
            grad_rel=max(float((a - b).abs().max() / b.abs().max())
                         for a, b in zip(grads["cuda"], grads["cpu"])),
            grad_l2=float(torch.cat([(a - b).reshape(-1) for a, b in zip(grads["cuda"], grads["cpu"])]).norm()
                          / torch.cat([b.reshape(-1) for b in grads["cpu"]]).norm()))
    sums, loss_rel, grad_rel, grad_l2 = (parts["auto"][k] for k in ("sums", "loss_rel", "grad_rel",
                                                                    "grad_l2"))
    plain = parts["shard_map"]
    auto_vs_plain = max(float((a - b).abs().max()) for dev in ("cuda", "cpu")
                        for a, b in zip(parts["auto"]["grads"][dev], plain["grads"][dev]))
    if not (loss_rel <= AUTO22_RTOL and sums["cuda"][1] == sums["cpu"][1] == 128):
        raise SystemExit(f"chip_smoke: 22 mode auto card vs CPU: sums {sums}, loss relative {loss_rel}, "
                         f"gradient relative {grad_rel}")
    phase("22 mode auto", f"cifar10_alexnet_h100.yaml mode auto, world 1: {steps} updates, "
          f"{launches[fused_adam.kernel.symbol]} Adam launches, epoch 1 train_loss="
          f"{history[0]['train_loss']:.4f} test_loss={history[0]['test_loss']:.4f} (the float32 run's "
          f"2.9944 / 2.3076), wall {wall_s:.2f} s; one AlexNet@224 b128 step (dropout 0) on the card "
          f"against the CPU from one state: loss sum {float(sums['cuda'][0])!r} vs "
          f"{float(sums['cpu'][0])!r} (relative {loss_rel:.3g}, tolerance {AUTO22_RTOL:g}); the gradient "
          f"(not held) {grad_l2:.3g} off in relative L2, elementwise up to {grad_rel:.3g} of a leaf's "
          f"largest element; the plain step (mode shard_map) from the same state and batch: loss sum "
          f"{float(plain['sums']['cuda'][0])!r} vs {float(plain['sums']['cpu'][0])!r} (relative "
          f"{plain['loss_rel']:.3g}), its gradient {plain['grad_l2']:.3g} off the CPU's in relative L2, "
          f"elementwise up to {plain['grad_rel']:.3g}; auto vs plain on one device: max |d grad| "
          f"{auto_vs_plain:.3g}")
    return dict(launches=launches[fused_adam.kernel.symbol], updates=steps,
                losses=[history[0]["train_loss"], history[0]["test_loss"]],
                card_vs_cpu_loss_sum=[float(sums["cuda"][0]), float(sums["cpu"][0])],
                loss_rel=loss_rel, grad_rel=grad_rel, grad_l2_rel=grad_l2,
                plain_card_vs_cpu={k: plain[k] for k in ("loss_rel", "grad_rel", "grad_l2")},
                auto_vs_plain_grad_max_abs=auto_vs_plain)


def snapshot_world2_phase():
    """Phase 22: step snapshots and the agreed drain at world 2 on one host
    (the pair's turns), and mode auto (world 1 here, world 2 in the pair)."""
    auto_1 = auto_world_1()
    root = tempfile.mkdtemp(prefix="tpuddp_torch_snap2_")
    try:
        turns, stdouts, wall_s = pair_runs(root)
        steps = pair_checks(turns, stdouts)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    medians = [(t["label"], statistics.median(t["rows"][1]["step_ms"]))
               for t in turns if t["label"] in ("off", "a")]
    per = {t["label"]: t for t in turns}
    a, b = per["a"], per["b"]
    snaps = {lab: {r: per[lab]["ranks"][r]["snapshots"] for r in (0, 1)} for lab in ("a",)}
    updates = 16
    engine_ms = {lab: {r: s[r]["engine_s"] * 1e3 / updates for r in (0, 1)} for lab, s in snaps.items()}
    polls = {lab: {r: per[lab]["ranks"][r]["poll"] for r in (0, 1)}
             for lab in ("off", "a", "b", "c", "auto", "poll")}
    phase("22 snapshots world 2", f"card {card_line()}: cifar10_resnet18_small_h100.yaml b128 a rank, "
          f"bf16_ef, ZeRO-1, 2 synthetic epochs of 8 steps, snapshot every 4 steps, world 2 = two rank "
          f"processes of one host over Gloo on this card: (b) preempt@step={PREEMPT22_STEP} exit 75 on "
          f"both ranks, one preempt row at epoch 1 step {steps}; (c) resumed there, epoch rows and "
          f"ckpt_1.npz bitwise (a)'s; snapshots (a) {snaps['a']}; the loop's ms a step in the engine "
          f"{engine_ms}; the agreed poll per exchange in each turn (a rank's wait for the other "
          f"included) and alone ({POLL22_N} back to back) {polls}; epoch-2 step medians in turns "
          + ", ".join(f"{lab} {m:.3f} ms" for lab, m in medians)
          + f"; mode auto pair (resnet18_small sync_bn, none): rows "
          f"{[[round(r['train_loss'], 4), round(r['test_loss'], 4)] for r in per['auto']['rows']]}, "
          f"both ranks' parameters bitwise equal after each epoch; pair wall {wall_s:.1f} s")
    launches = {f"native world-2 {t['label']} turn {i} rank {r} (phase 22)": t["ranks"][r]["launches"]
                for i, t in enumerate(turns) if t["label"] != "poll" for r in (0, 1)}
    launches["native mode auto AlexNet world 1 (phase 22)"] = auto_1["launches"]
    return dict(auto_world_1=auto_1, drain_step=steps, step_ms_medians=medians, snapshots=snaps,
                engine_ms_per_step=engine_ms, poll=polls, pair_wall_s=wall_s,
                auto_pair_rows=[[r["train_loss"], r["test_loss"]] for r in per["auto"]["rows"]],
                launches=launches)


# ---------------------------------------------------------------- phase 23 --

# the live plane: cifar10_alexnet_h100.yaml one synthetic epoch one step per
# batch (the host-bound case), in variants: off (observability: false, no
# step_stats window); the windows alone (a step_stats window every 4
# updates); the plane alone (the exporter, tracing; the flight recorder and
# aggregation by default); the plane with the windows, unscraped and
# scraped by a thread of this process every LIVE_SCRAPE_S (the plane "on"
# as a user runs it). In turns, there and back, so drift meets every
# variant alike
LIVE_VARIANTS = {
    "off": ({"observability": False, "step_stats_every": 0}, False),
    "windows": ({"observability": False, "step_stats_every": 4}, False),
    "plane": ({"observability": {"exporter": True, "tracing": True}, "step_stats_every": 0}, False),
    "on unscraped": ({"observability": {"exporter": True, "tracing": True}, "step_stats_every": 4},
                     False),
    "on": ({"observability": {"exporter": True, "tracing": True}, "step_stats_every": 4}, True),
}
LIVE_TURNS = tuple(LIVE_VARIANTS) + tuple(reversed(LIVE_VARIANTS))
LIVE_SCRAPE_S = 0.02


class _SyncCounts:
    """Counts ``torch.cuda.synchronize``, ``torch.cuda.Event.synchronize``
    and ``Tensor.item`` calls while it is entered."""

    def __enter__(self):
        self.counts = {"torch.cuda.synchronize": 0, "Event.synchronize": 0, "Tensor.item": 0}
        self._saved = (torch.cuda.synchronize, torch.cuda.Event.synchronize, torch.Tensor.item)
        sync, event_sync, item = self._saved
        counts = self.counts

        def counted_sync(*a, **k):
            counts["torch.cuda.synchronize"] += 1
            return sync(*a, **k)

        def counted_event_sync(ev):
            counts["Event.synchronize"] += 1
            return event_sync(ev)

        def counted_item(t):
            counts["Tensor.item"] += 1
            return item(t)

        torch.cuda.synchronize, torch.cuda.Event.synchronize, torch.Tensor.item = (
            counted_sync, counted_event_sync, counted_item)
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize, torch.cuda.Event.synchronize, torch.Tensor.item = self._saved


def _scrape_live(save_dir: str, stop: threading.Event, seen: dict) -> None:
    """While the run lives: ``/metrics`` and ``/snapshot`` of the exporter
    named in ``save_dir``'s port file (once ``/healthz`` answers), every
    :data:`LIVE_SCRAPE_S`; ``train_steps_total`` of each, and each
    response whole (every sample line a name and a number, the JSON
    parsed)."""
    import urllib.request

    from tpuddp_torch.observability.exporter import read_live_port

    port = None
    while not stop.is_set():
        if port is None:
            port = read_live_port(save_dir, probe_timeout=0.2)
        else:
            try:
                text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                              timeout=2).read().decode()
                snap = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/snapshot",
                                                         timeout=2).read())
            except OSError:
                seen["refused"] += 1  # the run closed the endpoint
            else:
                lines = [l for l in text.splitlines() if l and not l.startswith("#")]
                if not text.endswith("\n") or not all(
                        len(l.rsplit(" ", 1)) == 2 and _is_number(l.rsplit(" ", 1)[1]) for l in lines):
                    seen["torn"] += 1
                steps = [float(l.split()[1]) for l in lines if l.startswith("tpuddp_train_steps_total ")]
                seen["metrics"] += steps
                seen["snapshot"].append(snap["series"].get("train_steps_total", {}).get("value"))
        stop.wait(LIVE_SCRAPE_S)


def _is_number(text: str) -> bool:
    try:
        float(text)
        return True
    except ValueError:
        return False


def live_run(label: str, overrides: dict, root: str, scrape: bool):
    """One epoch of a live variant through the entry point's worker, the
    counts set to 0 just before it and read just after; the epoch-end save
    replaced by clones of the parameters and the moments on the card (no
    685 MB write); with ``scrape``, a thread scraping its exporter."""
    settings, training = training_for(SETTINGS)
    training.update(scan_steps=1, step_stats_every=overrides["step_stats_every"])
    save_dir = os.path.join(root, label)
    os.makedirs(save_dir)
    states = []
    real_save = ckpt.save_on_main

    def keep(save_dir, epoch, model, optimizer, *args, **kwargs):
        states.append([p.detach().clone() for p in model.parameters()] + [
            st[k].detach().clone() for st in optimizer.state.values() for k in sorted(st)
            if torch.is_tensor(st[k])])

    seen = {"metrics": [], "snapshot": [], "torn": 0, "refused": 0}
    stop = threading.Event()
    scraper = None
    if scrape:
        scraper = threading.Thread(target=_scrape_live, args=(save_dir, stop, seen), daemon=True)
        scraper.start()
    ckpt.save_on_main = keep
    reset_counts()
    try:
        with _SyncCounts() as counts:
            history = run_ddp_training(
                partial(basic_ddp_training_loop, training=training, device="cuda",
                        observability=cfg_lib.resolve_observability(overrides["observability"])),
                1, save_dir, cfg_lib.optional_args_from(settings), backend="cuda")
    finally:
        ckpt.save_on_main = real_save
        stop.set()
        if scraper is not None:
            scraper.join(timeout=30)
    torch.cuda.synchronize()
    return dict(history=history, states=states, syncs=counts.counts, seen=seen, dir=save_dir,
                launches={k.symbol: k.launches for k in fused_adam.kernels.values()})


def _live_files(run: dict) -> None:
    """The first scraped run's files into ``run``: its history, its trace
    (validated by the port's validator), what is left in its directory."""
    from tpuddp_torch.observability import schema

    with open(os.path.join(run["dir"], "history.jsonl")) as f:
        run["records"] = [json.loads(line) for line in f]
    trace = os.path.join(run["dir"], "trace_train.json")
    run["trace_errors"], run["spans"] = schema.validate_trace_file(trace)
    run["history_errors"], _ = schema.validate_history_file(os.path.join(run["dir"], "history.jsonl"))
    with open(trace) as f:
        run["kinds"] = sorted({e["cat"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"})
    run["left"] = sorted(os.listdir(run["dir"]))


def live_phase():
    """Phase 23: the live plane's variants (:data:`LIVE_VARIANTS`) in turns
    over one host-bound AlexNet epoch each: losses, parameters and moments
    bitwise, the same Adam launches, the same ``torch.cuda.synchronize``
    and ``Tensor.item`` calls; the scraped ``train_steps_total`` monotone up
    to the run's updates, every response whole; the trace valid under the
    port's validator; each variant's step medians."""
    root = tempfile.mkdtemp(prefix="tpuddp_torch_live_")
    runs, ref, same = [], None, []
    try:
        for i, label in enumerate(LIVE_TURNS):
            overrides, scrape = LIVE_VARIANTS[label]
            run = live_run(f"{i}_{label}", overrides, root, scrape)
            run["label"] = label
            states = run.pop("states")
            if ref is None:
                ref = states
            same.append(len(states) == 1 and len(states[0]) == len(ref[0])
                        and all(torch.equal(a, b) for a, b in zip(states[0], ref[0])))
            del states
            if label == "on" and not any(r["label"] == "on" for r in runs):
                _live_files(run)
            runs.append(run)
        del ref
    finally:
        shutil.rmtree(root, ignore_errors=True)
    f32 = fused_adam.kernel.symbol
    first_on = next(r for r in runs if "records" in r)
    header = first_on["records"][0]
    windows = [r for r in first_on["records"] if r["type"] == "step_stats"]
    summary = [r for r in first_on["records"] if r["type"] == "trace_summary"]
    rows = [[[r[k] for k in ("train_loss", "test_loss", "test_accuracy")] for r in run["history"]]
            for run in runs]
    scraped = [r for r in runs if r["label"] == "on"]
    updates = sum(len(r["step_ms"]) for r in runs[0]["history"])
    medians = {label: [statistics.median(r["history"][0]["step_ms"][1:]) for r in runs
                       if r["label"] == label] for label in LIVE_VARIANTS}
    median = {label: statistics.median(v) for label, v in medians.items()}
    syncs = {label: next(r["syncs"] for r in runs if r["label"] == label) for label in LIVE_VARIANTS}

    def scrapes_ok(seen):
        steps = seen["metrics"]
        # a scrape between the loop's detaching its source and the endpoint's
        # stop sees no training series
        snap = [v for v in seen["snapshot"] if v is not None]
        return (len(steps) > 0 and all(a <= b for a, b in zip(steps, steps[1:]))
                and steps[-1] == updates and snap[-1:] == [updates] and seen["torn"] == 0)

    checks = {
        "losses bitwise in every run": all(r == rows[0] for r in rows),
        "parameters and moments bitwise in every run": all(same),
        "16 Adam launches a run, no other kernel": updates == 16 and all(
            r["launches"][f32] == sum(r["launches"].values()) == 16 for r in runs),
        "as many torch.cuda.synchronize and Tensor.item calls in every run": all(
            r["syncs"][k] == runs[0]["syncs"][k] for r in runs
            for k in ("torch.cuda.synchronize", "Tensor.item")),
        "train_steps_total scraped in each scraped run, monotone to the updates, /snapshot "
        "agreeing, every response whole": all(scrapes_ok(r["seen"]) for r in scraped),
        "the trace valid (port validator), every training kind (collective: a hook's or the "
        "overlap's)": not first_on["trace_errors"] and first_on["spans"] > 0
        and {"dispatch", "epoch", "readback", "stage"} <= set(first_on["kinds"])
        and ("collective" in first_on["kinds"]) == (
            header["comm_hook"] != "none" or bool(header["comm"]["overlap"]["enabled"])),
        "the history valid, header with the bound port and the tracer": not first_on["history_errors"]
        and header["observability"]["exporter"]["port"] > 0
        and header["observability"]["flight_recorder"] == {"capacity": 64}
        and header["tracing"] == {"capacity": 4096, "artifact": "trace_train.json"}
        and len(summary) == 1 and len(windows) == 4,
        "a clean exit leaves no flight recording and no port file": first_on["left"] == [
            "history.jsonl", "trace_train.json"],
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 23 live plane failed {failed}: " + "; ".join(
            f"{r['label']}: {r['syncs']} {r['launches']} scraped {r['seen']['metrics'][-5:]} "
            f"{r['seen']['snapshot'][-3:]} torn {r['seen']['torn']}" for r in runs)
            + f"; rows {rows}; same {same}; trace {first_on['trace_errors'][:5]} {first_on['kinds']}; "
            f"history {first_on['history_errors'][:5]}; files {first_on['left']}")
    n_scrapes = [len(r["seen"]["metrics"]) for r in scraped]
    phase("23 live plane", f"card {card_line()}: cifar10_alexnet_h100.yaml one epoch one step per batch "
          f"a run, in turns {'/'.join(LIVE_TURNS)}: losses {rows[0][0][0]!r}/{rows[0][0][1]!r}, "
          f"parameters and moments bitwise in every run, 16 Adam launches each; calls per variant "
          f"{json.dumps(syncs)} (the windows' waits are Event.synchronize); {n_scrapes} /metrics "
          f"scrapes every {LIVE_SCRAPE_S * 1e3:.0f} ms in the scraped runs, train_steps_total "
          f"monotone to 16, all whole; trace {first_on['spans']} spans {summary[0]['by_kind']}; step "
          f"medians (steps 2-16, each run) " + ", ".join(
              f"{label} {'/'.join(f'{m:.3f}' for m in v)} ms" for label, v in medians.items())
          + "; the median of each variant's two against off's: " + ", ".join(
              f"{label} {median[label] / median['off']:.4f}" for label in LIVE_VARIANTS
              if label != "off"))
    return dict(step_ms_medians=medians, ratio_to_off={label: median[label] / median["off"]
                                                       for label in LIVE_VARIANTS},
                syncs=syncs, scrapes=n_scrapes, by_kind=summary[0]["by_kind"], windows=len(windows),
                losses=rows[0][0],
                launches={f"native AlexNet live plane {r['label']} turn {i} (phase 23)":
                          r["launches"][f32] for i, r in enumerate(runs)})

# ---------------------------------------------------------------- phase 24 --
# transformer_small at full width (tpuddp/models/__init__.py:36-44: d 128,
# 8 heads, 4 layers, 256 positions) and the serving vocabulary
# (tpuddp/config.py:206: 256); the decode defaults (tpuddp/config.py:211-218:
# 8 slots, 64 blocks of 16); prompts of three lengths in three slots, 32
# decode steps; 64 sequences of 256 tokens a step, 2 epochs of 16 steps
TF_NAME, TF_VOCAB, TF_SEQ = "transformer_small", 256, 256
TF_SLOTS, TF_BLOCKS, TF_BLOCK_SIZE, TF_NEW = 8, 64, 16, 32
TF_PROMPTS = {0: 17, 3: 40, 6: 64}  # slot -> prompt length
TF_GLOBAL_BATCH, TF_STEPS = 64, 16
TF_TURNS = ("eager", "replay", "replay", "eager")
TF_FWD_TOL = 1e-4  # rtol and atol of the card's forward (TF32 off) against the CPU's
TF_LOSS_RTOL = 1e-3  # the card's first 3 step losses against the CPU port's
TF_LOADERS = partial(token_loaders, vocab=TF_VOCAB, seq_len=TF_SEQ, global_batch=TF_GLOBAL_BATCH,
                     n_batches=TF_STEPS)


def _token_tree(seed: int) -> dict:
    """transformer_small's parameters in the JAX package's tree and layouts,
    drawn with numpy by the JAX init laws (``tpuddp/models/transformer.py:
    101-146``): embeddings N(0, 0.02), projections U(+-1/sqrt(fan_in)),
    zero biases, LayerNorms ones and zeros."""
    rng = np.random.default_rng(seed)
    spec = load_model(TF_NAME, TF_VOCAB)
    e, f = spec.d_model, spec.d_mlp

    def uni(fan_in, shape):
        bound = 1.0 / math.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    zeros = lambda n: np.zeros(n, np.float32)
    ln = lambda: {"bias": zeros(e), "scale": np.ones(e, np.float32)}
    blocks = tuple({
        "attn": {"bo": zeros(e), "bqkv": zeros(3 * e), "wo": uni(e, (e, e)), "wqkv": uni(e, (e, 3 * e))},
        "ln1": ln(), "ln2": ln(),
        "mlp": {"b1": zeros(f), "b2": zeros(e), "w1": uni(e, (e, f)), "w2": uni(f, (f, e))},
    } for _ in range(spec.n_layers))
    normal = lambda rows: (0.02 * rng.standard_normal((rows, e))).astype(np.float32)
    return {"blocks": blocks, "embed": {"weight": normal(TF_VOCAB)}, "ln_f": ln(),
            "pos": {"weight": normal(spec.max_seq_len)}}


def _token_model(tree, device: str):
    model = load_model(TF_NAME, TF_VOCAB)
    model.load_state_dict(state_dict_from_jax(TF_NAME, tree))
    return model.to(device)


def transformer_forward(tree):
    """24 forward: a (8, 256) token batch through the card's forward and
    the CPU's, from one converted tree."""
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, TF_VOCAB, (8, TF_SEQ)).astype(np.int32))
    with torch.no_grad():
        cpu = _token_model(tree, "cpu").eval()(toks)
        card = _token_model(tree, "cuda").eval()(toks.cuda()).cpu()
    err = float((card - cpu).abs().max())
    ok = bool(((card - cpu).abs() <= TF_FWD_TOL + TF_FWD_TOL * cpu.abs()).all())
    if not ok or tuple(card.shape) != (8, TF_SEQ, TF_VOCAB) or not torch.isfinite(card).all():
        raise SystemExit(f"chip_smoke: 24 forward: card vs CPU max |d| {err} (rtol/atol {TF_FWD_TOL})")
    phase("24 forward", f"{TF_NAME} (d 128, 8 heads, 4 layers, 256 positions, vocab 256), a (8, 256) "
          f"batch, TF32 off: card vs CPU max |d logits| {err:.3g} (within rtol/atol {TF_FWD_TOL})")
    return dict(max_abs_err=err)


def _decode_steps(model, pools, tables, lengths0, tokens0, graph: bool):
    """``TF_NEW`` greedy steps of every slot from copies of the prefilled
    pools and slot state: each step ``decode_step``, the argmax fed back
    (inactive slots keep token 0 at length 0), eagerly or as replays of one
    CUDA graph of a step. Returns ``(tokens (TF_NEW, S), last logits,
    kpool, vpool, ms a step)``."""
    kp, vp = (p.clone() for p in pools)
    lengths, tokens = lengths0.clone(), tokens0.clone()
    active = lengths0 > 0

    def step():
        logits, _, _ = model.decode_step(kp, vp, tables, lengths, tokens)
        tokens.copy_(torch.where(active, logits.argmax(-1).to(tokens.dtype), tokens))
        lengths.add_(active.to(lengths.dtype))
        return logits

    run = step
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm the capture's stream on throwaway copies
            model.decode_step(kp.clone(), vp.clone(), tables, lengths.clone(), tokens.clone())
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            static = step()
        run = lambda: (g.replay(), static)[1]
    history = []
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(TF_NEW):
        logits = run()
        history.append(tokens.clone())
    stop.record()
    stop.synchronize()
    return torch.stack(history), logits.clone(), kp, vp, start.elapsed_time(stop) / TF_NEW


def transformer_decode(tree):
    """24 decode: the decode defaults' pools, three prompts prefilled at
    their buckets into slots of their own (blocks from a seeded
    permutation), 32 greedy steps eagerly and replayed from one captured
    graph: the replay bitwise the eager run (tokens, logits, pools), and
    every sequence's 33 tokens those of greedy decoding by repeated full
    forwards on the card."""
    model = _token_model(tree, "cuda").eval()
    rng = np.random.default_rng(2)
    shape = (model.n_layers, TF_BLOCKS, TF_BLOCK_SIZE, model.n_heads, model.head_dim)
    kpool, vpool = torch.zeros(shape, device="cuda"), torch.zeros(shape, device="cuda")
    width = TF_SEQ // TF_BLOCK_SIZE
    need = -(-(max(TF_PROMPTS.values()) + TF_NEW) // TF_BLOCK_SIZE)
    free = iter(rng.permutation(np.arange(1, TF_BLOCKS)))  # block 0: the garbage block
    tables = np.zeros((TF_SLOTS, width), np.int32)
    lengths, tokens = np.zeros(TF_SLOTS, np.int32), np.zeros(TF_SLOTS, np.int32)
    prompts, buckets = {}, tf_lib.prefill_buckets(TF_SEQ)
    for slot, n in TF_PROMPTS.items():
        tables[slot, :need] = [next(free) for _ in range(need)]
        prompts[slot] = rng.integers(0, TF_VOCAB, n).astype(np.int32)
        bucket = min(b for b in buckets if b >= n)
        buf = np.zeros((1, bucket), np.int32)
        buf[0, :n] = prompts[slot]
        last, kpool, vpool = model.prefill(kpool, vpool, torch.from_numpy(tables[slot]).cuda(),
                                           torch.from_numpy(buf).cuda(), n)
        tokens[slot], lengths[slot] = int(last.argmax()), n
    dev = lambda a: torch.from_numpy(a).cuda()
    runs = {mode: _decode_steps(model, (kpool, vpool), dev(tables), dev(lengths), dev(tokens), mode == "replay")
            for mode in ("eager", "replay")}
    (t_e, l_e, k_e, v_e, ms_e), (t_r, l_r, k_r, v_r, ms_r) = runs["eager"], runs["replay"]
    bitwise = all(torch.equal(a, b) for a, b in ((t_e, t_r), (l_e, l_r), (k_e, k_r), (v_e, v_r)))
    got = {slot: [int(tokens[slot])] + t_e[:, slot].tolist() for slot in TF_PROMPTS}
    want = {}
    with torch.no_grad():
        for slot in TF_PROMPTS:
            seq = torch.from_numpy(prompts[slot]).cuda()
            out = []
            for _ in range(TF_NEW + 1):
                out.append(int(model(seq[None])[0, -1].argmax()))
                seq = torch.cat([seq, seq.new_tensor([out[-1]])])
            want[slot] = out
    checks = {
        "the replay bitwise the eager run (tokens, logits, pools)": bitwise,
        "greedy tokens those of repeated full forwards": got == want,
        "inactive slots stay at token 0, length 0": bool((t_e[:, [s for s in range(TF_SLOTS)
                                                                 if s not in TF_PROMPTS]] == 0).all()),
        "finite logits": bool(torch.isfinite(l_e).all()),
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 24 decode failed {failed}: got {got}, want {want}")
    phase("24 decode", f"{TF_SLOTS} slots, {TF_BLOCKS} blocks of {TF_BLOCK_SIZE}; prompts of "
          f"{list(TF_PROMPTS.values())} tokens prefilled in slots {list(TF_PROMPTS)}, {TF_NEW} greedy "
          f"steps: replay bitwise eager, tokens equal repeated full forwards; decode_step ms a step "
          f"eager {ms_e:.4f}, replayed {ms_r:.4f}")
    return dict(decode_ms_eager=ms_e, decode_ms_replay=ms_r, tokens=got)


def _tf_training(mode: str, save_dir: str):
    """The native worker on the token job (``run_ddp_training`` at world 1)
    with graph replay or eagerly, checkpoints into ``save_dir``; counts set
    to 0 just before and read just after."""
    training = dict(cfg_lib.TRAINING_DEFAULTS, model=TF_NAME, num_classes=TF_VOCAB, seed=0,
                    dataset="synthetic_tokens", num_epochs=2, checkpoint_epoch=1, scan_steps="auto")
    os.makedirs(save_dir, exist_ok=True)
    reset_counts()
    graphs.reset_stats()
    DistributedDataParallel._graph_replay = mode != "eager"
    t0 = time.perf_counter()
    try:
        history = run_ddp_training(
            partial(basic_ddp_training_loop, training=training, device="cuda", loaders=TF_LOADERS),
            1, save_dir, {}, backend="cuda")
        torch.cuda.synchronize()
    finally:
        DistributedDataParallel._graph_replay = True
    launches = {k.symbol: k.launches for k in fused_adam.kernels.values()}
    return dict(history=history, launches=launches, graphs=_kinds(graphs.stats),
                wall_s=time.perf_counter() - t0, path=os.path.join(save_dir, "ckpt_1.npz"))


def _state_diff(a_path: str, b_path: str):
    """The keys whose arrays differ between two checkpoints: ``(the
    training state's: parameters, moments, step counts; the others')``."""
    a, b = _arrays(a_path), _arrays(b_path)
    differ = sorted(k for k in set(a) | set(b)
                    if k not in a or k not in b or not np.array_equal(a[k], b[k]))
    return [k for k in differ if k.startswith(".")], [k for k in differ if not k.startswith(".")]


def transformer_steps(tree, flops_per_step: float, peak: float):
    """24 steps: from one converted tree, the first 3 steps' losses on the
    card against the CPU port's; then chunks of 16 (eager, captured,
    replayed) on the card: the replayed step's time, 2 Adam launches an
    update."""
    batches = list(TokenLMLoader(TF_VOCAB, TF_SEQ, TF_GLOBAL_BATCH, TF_STEPS, seed=0))
    losses = {}
    for device in ("cpu", "cuda"):
        model = _token_model(tree, device)
        ddp = DistributedDataParallel(model, Adam(model.parameters(), lr=1e-3), CrossEntropyLoss(),
                                      device=device)
        losses[device] = [float(s[0] / s[1]) for s in (ddp.train_step(b) for b in batches[:3])]
    rel = max(abs(g - c) / abs(c) for g, c in zip(losses["cuda"], losses["cpu"]))
    reset_counts()
    chunk_s = []
    for _ in range(3):  # the signature's eager group, its capture, a replay
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ddp.train_step_many(batches)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    launches = fused_adam.kernel.launches
    step_ms = chunk_s[-1] * 1e3 / TF_STEPS
    tokens = TF_GLOBAL_BATCH * TF_SEQ
    checks = {
        f"first 3 losses within rtol {TF_LOSS_RTOL} of the CPU port's": rel <= TF_LOSS_RTOL,
        "2 Adam launches an update in the chunks": launches == 2 * 3 * TF_STEPS,
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 24 steps failed {failed}: losses {losses}, launches {launches}")
    mfu = flops_per_step / (step_ms / 1e3) / peak
    phase("24 steps", f"first 3 step losses card {[round(x, 6) for x in losses['cuda']]} vs CPU "
          f"{[round(x, 6) for x in losses['cpu']]} (max rel {rel:.2e}); a chunk of {TF_STEPS} steps "
          f"eager/captured/replayed s {', '.join(f'{t:.4f}' for t in chunk_s)}: replayed step {step_ms:.3f} ms, "
          f"{tokens * 1e3 / step_ms:.0f} tokens/s, MFU {mfu:.4f} of the bf16 peak; {launches} Adam launches "
          f"for {3 * TF_STEPS} updates")
    return dict(losses=losses, max_rel=rel, chunk_s=chunk_s, replayed_step_ms=step_ms,
                tokens_per_s=tokens * 1e3 / step_ms, mfu=mfu, launches=launches)


def transformer_training(root: str):
    """24 training: the token job through the native worker, eagerly and at
    ``scan_steps: auto`` with graph replay in turns: finite losses that
    fall, every token counted, 2 Adam launches an update, the replay's
    graphs, every run's epoch rows and final checkpoint bitwise the first's."""
    runs = [_tf_training(mode, os.path.join(root, f"{i}_{mode}")) for i, mode in enumerate(TF_TURNS)]
    f32 = fused_adam.kernel.symbol
    updates = 2 * TF_STEPS
    rows = [[(r["train_loss"], r["test_loss"], r["test_accuracy"]) for r in run["history"]] for run in runs]
    diff = [_state_diff(runs[0]["path"], run["path"]) for run in runs[1:]]
    checks = {
        "2 epochs of 16 steps": all([len(r["step_ms"]) for r in run["history"]] == [TF_STEPS] * 2
                                    for run in runs),
        "2 Adam launches an update, no other kernel": all(
            run["launches"][f32] == sum(run["launches"].values()) == 2 * updates for run in runs),
        "finite losses": all(math.isfinite(x) for row in rows for r in row for x in r),
        "the train loss falls": all(row[1][0] < row[0][0] for row in rows),
        "every token counted": all((r["train_samples"], r["test_samples"]) == (
            TF_STEPS * TF_GLOBAL_BATCH * TF_SEQ, 4 * TF_GLOBAL_BATCH * TF_SEQ)
            for run in runs for r in run["history"]),
        "replay: 1 capture and 1 replay of train and eval; eager: none": all(
            run["graphs"] == ({"train": (1, 1), "eval": (1, 1)} if mode == "replay" else {})
            for mode, run in zip(TF_TURNS, runs)),
        "every run's epoch rows bitwise the first's": all(r == rows[0] for r in rows),
        "every run's final parameters, moments and step counts bitwise the first's": all(
            not diffs[0] for diffs in diff),
        "mfu_p50 a number": all(r["mfu_p50"] is not None for run in runs for r in run["history"]),
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 24 training failed {failed}: "
                         + json.dumps([{k: run[k] for k in ("launches", "graphs")} for run in runs])
                         + f" rows {rows}, checkpoint keys that differ from the first run's {diff}")
    medians = {m: [statistics.median(run["history"][1]["step_ms"]) for mode, run in zip(TF_TURNS, runs)
                   if mode == m] for m in dict.fromkeys(TF_TURNS)}
    eager = runs[0]["history"][1]
    phase("24 training", f"run_ddp_training world 1, the token loader ({TF_GLOBAL_BATCH} x {TF_SEQ} tokens a "
          f"step), 2 epochs of {TF_STEPS}, Adam float32, turns {'/'.join(TF_TURNS)}: train_loss "
          f"{rows[0][0][0]:.4f} -> {rows[0][1][0]:.4f}, test_loss {rows[0][0][1]:.4f} -> {rows[0][1][1]:.4f}; "
          f"rows and the final parameters, moments and step counts bitwise across runs (other "
          f"checkpoint keys that differ: {sorted(set(k for d in diff for k in d[1]))}); {2 * updates} "
          f"Adam launches a run; epoch 2 step median "
          f"ms {medians} (replay: the epoch of the capture); eager epoch 2 mfu_p50 {eager['mfu_p50']}; "
          f"wall s {[round(run['wall_s'], 2) for run in runs]}")
    return dict(rows=rows[0], medians=medians, mfu_p50_eager=eager["mfu_p50"],
                step_ms_eager=statistics.median(eager["step_ms"]),
                launches={f"native {TF_NAME} {mode} turn {i} (phase 24)": run["launches"][f32]
                          for i, (mode, run) in enumerate(zip(TF_TURNS, runs))},
                wall_s=[run["wall_s"] for run in runs])


def transformer_phase(bw, flops):
    """Phase 24: transformer_small's forward, decode and training on the
    card, and the Adam update over its 52 leaves."""
    tree = _token_tree(0)
    out = {"forward": transformer_forward(tree), "decode": transformer_decode(tree)}
    torch.cuda.empty_cache()
    with torch.device("meta"):
        meta = load_model(TF_NAME, TF_VOCAB)
    shapes = [tuple(p.shape) for p in meta.parameters()]
    step_flops = count_step_flops(meta, (TF_GLOBAL_BATCH, TF_SEQ), torch.int32)
    peak = device_peak_flops(torch.cuda.get_device_name(0))
    out["steps"] = transformer_steps(tree, step_flops, peak)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="tpuddp_torch_tokens_")
    try:
        out["training"] = transformer_training(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wrapper = fused_adam.kernel
    err = compare(wrapper, [(TF_NAME, shapes, "", 0.0)], shapes, tag="24 adam", p_relative=True)
    torch.cuda.empty_cache()
    out["kernel"] = {**time_kernel(wrapper, shapes, bw, flops, label=TF_NAME, tag="24 adam"),
                     "max_abs_err": err, "launches_per_step": _tables(len(shapes))}
    graphed = adam_graph_ms(wrapper, shapes)
    out["kernel"].update(graph_ms=graphed["kernel"], library_graph_ms=graphed["library"])
    bound = out["kernel"]["bound_ms"]
    phase("24 adam", f"one {TF_NAME} Adam step replayed from a CUDA graph (2 launches, no host enqueue), "
          f"best of two in turns: kernel {graphed['kernel']:.4f} ms ({100 * bound / graphed['kernel']:.1f}% of "
          f"the {bound:.4f} ms bound), torch.optim.Adam(fused=True, capturable=True) "
          f"{graphed['library']:.4f} ms")
    out["leaves"] = len(shapes)
    out["flops_per_step"] = step_flops
    phase("24 transformer", f"card {card_line()}: {len(shapes)} leaves, {_tables(len(shapes))} Adam launches "
          f"an update; {step_flops:.4g} FLOPs a step (forward and backward, counted)")
    return out


# ---------------------------------------------------------------- phase 25 --
# tensor parallel: transformer_small at full width at parallel.model 2 on a
# world of 2 (data 1) on the one card over Gloo; 8 epochs of one (8, 256)
# batch through the loop (each epoch's train loss is one step's), one eval
# batch an epoch, the first and the last epoch saved
TP25_MODEL, TP25_BATCH, TP25_STEPS = 2, 8, 8
TP25_FWD_ATOL = 2e-5  # tests/test_mesh2d.py:228-250
TP25_LOSS_ATOL = 1e-4  # tests/test_mesh2d.py:283-296
TP25_FWD, TP25_BWD = 10, 9  # collectives of a train step: 1 + 2 a block + 1; 2 a block + 1
TP25_S = 600
TP25_TRAINING = dict(model=TF_NAME, num_classes=TF_VOCAB, seed=0, dataset="synthetic_tokens",
                     num_epochs=TP25_STEPS, checkpoint_epoch=TP25_STEPS - 1, scan_steps=1)
TP25_LOADERS = dict(vocab=TF_VOCAB, seq_len=TF_SEQ, global_batch=TP25_BATCH, n_batches=1,
                    test_batches=1)
# one rank of the pair: the weights of init.npz cut to its shard, (a) the
# forward of x.npy, then (b) the loop with the counts set to 0 just before
# and read just after, then the gathered parameters (rank 0 writes)
TP25_SCRIPT = (
    "import json, os, sys\n"
    "from functools import partial\n"
    "import numpy as np, torch\n"
    "from tpuddp_torch import config as cfg_lib, train_native\n"
    "from tpuddp_torch.data.tokens import token_loaders\n"
    "from tpuddp_torch.ops import fused_adam\n"
    "from tpuddp_torch.parallel import spawn, tensor as tp_lib\n"
    "from tpuddp_torch.training.loop import run_training_loop\n"
    "rank, work = int(sys.argv[1]), sys.argv[2]\n"
    "ports = [int(p) for p in sys.argv[3].split(',')]\n"
    "with open(os.path.join(work, 'job.json')) as f:\n"
    "    job = json.load(f)\n"
    "def fn(rank, world, save_dir, _):\n"
    "    for k in fused_adam.kernels.values():\n"
    "        k.load()\n"
    "    training = dict(cfg_lib.TRAINING_DEFAULTS, **job['training'])\n"
    "    ddp, train, test, seed = train_native.build_training(\n"
    "        rank, world, training, 'cuda', partial(token_loaders, **job['loaders']),\n"
    "        cfg_lib.resolve_parallel(job['parallel']))\n"
    "    with np.load(os.path.join(work, 'init.npz')) as data:\n"
    "        full = {k: torch.from_numpy(data[k]) for k in data.files}\n"
    "    ddp.model.load_state_dict(tp_lib.local_state_dict(full, ddp.mesh.model_index, ddp.model_size))\n"
    "    x = torch.from_numpy(np.load(os.path.join(work, 'x.npy'))).cuda()\n"
    "    with torch.no_grad():\n"
    "        np.save(os.path.join(work, f'logits_{rank}.npy'), ddp.model(x).cpu().numpy())\n"
    "    tp_lib.reset_counts()\n"
    "    for k in fused_adam.kernels.values():\n"
    "        k.reset_launches()\n"
    "    history = run_training_loop(ddp, train, test, save_dir, num_epochs=training['num_epochs'],\n"
    "                                checkpoint_epoch=training['checkpoint_epoch'], base_seed=seed,\n"
    "                                scan_steps=1, log=lambda *a, **k: None)\n"
    "    torch.cuda.synchronize()\n"
    "    out = {'counts': {k: tp_lib.collectives_issued(k) for k in ('forward', 'backward', 'eval')},\n"
    "           'launches': {k.symbol: k.launches for k in fused_adam.kernels.values()},\n"
    "           'local_params': sum(p.numel() for p in ddp.model.parameters()),\n"
    "           'leaves': len(list(ddp.model.parameters()))}\n"
    "    gathered = {k: v.cpu().numpy() for k, v in ddp.gather_params().items()}\n"
    "    if rank == 0:\n"
    "        out['history'] = history\n"
    "        np.savez(os.path.join(work, 'gathered.npz'), **gathered)\n"
    "    with open(os.path.join(work, f'rank_{rank}.json'), 'w') as f:\n"
    "        json.dump(out, f)\n"
    "spawn._worker(rank, fn, 2, os.path.join(work, 'out'), {}, 'cuda', ports[0], None, (0, 1))\n"
)


def _tp25_pair(work: str):
    """Both rank processes of the pair against stores held here, one a
    process group the ranks make in turn (phase 25's, then its snapshot
    legs', :data:`TP25S_SCRIPT`): each rank's JSON and the pair's wall
    seconds."""
    stores = [backend.rendezvous_store(2) for _ in range(TP25_GROUPS)]
    env = dict(os.environ, TPUDDP_BACKEND="gloo", PYTHONPATH=ROOT)
    for var in ("TPUDDP_FAULT", "TPUDDP_AUTO_RESUME", "TPUDDP_WORLD_SIZE", "TPUDDP_MODEL_SIZE",
                "TPUDDP_COORDINATOR", "TPUDDP_NUM_PROCESSES", "TPUDDP_PROCESS_ID"):
        env.pop(var, None)
    ports = ",".join(str(store.port) for store in stores)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", TP25_SCRIPT + TP25S_SCRIPT, str(rank), work,
                               ports], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TP25_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        del stores
    wall_s = time.perf_counter() - t0
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise SystemExit(f"chip_smoke: 25 pair: rank {rank} exited {p.returncode}:\n"
                             f"{out[-3000:]}\n{err[-5000:]}")
    ranks = []
    for rank in (0, 1):
        with open(os.path.join(work, f"rank_{rank}.json")) as f:
            ranks.append(json.load(f))
    return ranks, wall_s


def _tp25_reference(tree, root: str):
    """The same global batches at world 1, model 1, on the card through
    the native worker (eager: one step a dispatch)."""
    training = dict(cfg_lib.TRAINING_DEFAULTS, **TP25_TRAINING)
    init = state_dict_from_jax(TF_NAME, tree)

    def worker(rank, world, save_dir, optional_args):
        ddp, train, test, seed = build_training(rank, world, training, "cuda",
                                                partial(token_loaders, **TP25_LOADERS))
        ddp.model.load_state_dict(init)
        return run_training_loop(ddp, train, test, None, num_epochs=TP25_STEPS, base_seed=seed,
                                 scan_steps=1, log=lambda *a, **k: None)

    reset_counts()
    history = run_ddp_training(worker, 1, None, {}, backend="cuda")
    torch.cuda.synchronize()
    return history, fused_adam.kernel.launches


def tensor_parallel_phase(bw, flops):
    """Phase 25: transformer_small at parallel.model 2 on a world of 2 on
    the one card: (a) the forward, (b) 8 steps through the loop against a
    world-1 model-1 run, the collectives and the Adam launches, (c) the
    model-2 checkpoint restored at model 1, (e) step snapshots, the drain
    and the exact resume in the same pair (:func:`tp_snapshot_checks`), (d)
    the times."""
    tree = _token_tree(0)
    root = tempfile.mkdtemp(prefix="tpuddp_torch_tp_")
    try:
        np.savez(os.path.join(root, "init.npz"),
                 **{k: v.numpy() for k, v in state_dict_from_jax(TF_NAME, tree).items()})
        x = np.random.default_rng(25).integers(0, TF_VOCAB, (TP25_BATCH, TF_SEQ)).astype(np.int32)
        np.save(os.path.join(root, "x.npy"), x)
        with open(os.path.join(root, "job.json"), "w") as f:
            json.dump({"training": TP25_TRAINING, "loaders": TP25_LOADERS,
                       "parallel": {"model": TP25_MODEL}}, f)
        tp_snapshot_job(root)
        ranks, wall_s = _tp25_pair(root)
        # (a) the forward against the card's model 1 of the gathered weights
        model = _token_model(tree, "cuda").eval()
        with torch.no_grad():
            ref = model(torch.from_numpy(x).cuda()).cpu().numpy()
        fwd_err = max(float(np.abs(np.load(os.path.join(root, f"logits_{r}.npy")) - ref).max())
                      for r in (0, 1))
        # (b) the steps against world 1, model 1
        ref_history, ref_launches = _tp25_reference(tree, root)
        rows = ranks[0]["history"]
        losses = [r["train_loss"] for r in rows]
        ref_losses = [r["train_loss"] for r in ref_history]
        loss_err = max(abs(a - b) for a, b in zip(losses, ref_losses))
        f32 = fused_adam.kernel.symbol
        # (c) the model-2 file at world 1, model 1, reshaped on load
        restored = load_model(TF_NAME, TF_VOCAB).cuda()
        ckpt.restore_latest(os.path.join(root, "out"), restored,
                            Adam(restored.parameters(), lr=1e-3), reshard_on_mismatch=True)
        with np.load(os.path.join(root, "gathered.npz")) as data:
            gathered = {k: data[k] for k in data.files}
        ckpt_diff = [k for k, v in restored.state_dict().items()
                     if not np.array_equal(v.cpu().numpy(), gathered[k])]
        with np.load(os.path.join(root, "out", f"ckpt_{TP25_STEPS - 1}.npz")) as f:
            topo = json.loads(str(f["__topology__"]))
            wqkv = f[".params['blocks'][0]['attn']['wqkv']"].shape
        snapshots = tp_snapshot_checks(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    checks = {
        f"(a) each rank's tp_forward within atol {TP25_FWD_ATOL} of model 1": fwd_err <= TP25_FWD_ATOL,
        f"(b) {TP25_STEPS} step losses within {TP25_LOSS_ATOL} of world 1, model 1":
            len(losses) == len(ref_losses) == TP25_STEPS and loss_err <= TP25_LOSS_ATOL,
        f"(b) {TP25_FWD + TP25_BWD} model-axis collectives a train step on each rank": all(
            (r["counts"]["forward"], r["counts"]["backward"])
            == (TP25_FWD * TP25_STEPS, TP25_BWD * TP25_STEPS) for r in ranks),
        "(b) 2 Adam launches an update on each rank, no other kernel": all(
            r["launches"][f32] == sum(r["launches"].values()) == 2 * TP25_STEPS for r in ranks),
        "(b) every token of each step counted": all(
            r["train_samples"] == TP25_BATCH * TF_SEQ for r in rows),
        "(c) the model-2 file restored at model 1 bitwise the gathered parameters": not ckpt_diff,
        "(c) the file is a model-2 one in the TP layout": topo["model_size"] == TP25_MODEL
            and wqkv == (128, 3, 128),
        "the world-1 reference launched 2 tables an update": ref_launches == 2 * TP25_STEPS,
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 25 tensor parallel failed {failed}: forward {fwd_err}, losses "
                         f"{losses} vs {ref_losses}, ranks {[{k: r[k] for k in ('counts', 'launches')} for r in ranks]}, "
                         f"checkpoint keys that differ {ckpt_diff}")
    card = card_line()
    phase("25 forward", f"{TF_NAME} at parallel.model {TP25_MODEL} (world 2, data 1, Gloo on one card), "
          f"a ({TP25_BATCH}, {TF_SEQ}) batch: each rank's tp_forward vs the model-1 forward of the "
          f"gathered weights max |d logits| {fwd_err:.3g} (atol {TP25_FWD_ATOL}); card {card}")
    tp_ms = statistics.median(r["step_ms"][0] for r in rows[1:])
    one_ms = statistics.median(r["step_ms"][0] for r in ref_history[1:])
    phase("25 steps", f"{TP25_STEPS} steps through run_training_loop, eager: losses "
          f"{[round(v, 6) for v in losses]} vs world 1 model 1 max |d| {loss_err:.3g}; "
          f"collectives a train step {TP25_FWD} forward + {TP25_BWD} backward on each rank; "
          f"{2 * TP25_STEPS} Adam launches a rank ({ranks[0]['leaves']} local leaves, "
          f"{ranks[0]['local_params']} local parameters); step median (epochs 2..{TP25_STEPS}) "
          f"TP {tp_ms:.3f} ms vs model 1 {one_ms:.3f} ms (ratio {tp_ms / one_ms:.2f}); pair wall "
          f"{wall_s:.1f} s; card {card}")
    phase("25 checkpoint", f"ckpt_{TP25_STEPS - 1}.npz (model_size {topo['model_size']}, wqkv {wqkv}) "
          f"restored at world 1, model 1 with reshard_on_mismatch: parameters bitwise the gathered ones")
    with torch.device("meta"):
        shard = tp_lib.TensorParallelLM(load_model(TF_NAME, TF_VOCAB), _Mesh25())
    shapes = [tuple(p.shape) for p in shard.parameters()]
    wrapper = fused_adam.kernel
    err = compare(wrapper, [(f"{TF_NAME} model-2 shard", shapes, "", 0.0)], shapes, tag="25 adam",
                  p_relative=True)
    torch.cuda.empty_cache()
    kernel = {**time_kernel(wrapper, shapes, bw, flops, label=f"{TF_NAME} model-2 shard", tag="25 adam"),
              "max_abs_err": err, "launches_per_step": _tables(len(shapes)),
              "local_params": sum(math.prod(s) for s in shapes)}
    graphed = adam_graph_ms(wrapper, shapes)
    kernel.update(graph_ms=graphed["kernel"], library_graph_ms=graphed["library"])
    phase("25 times", f"card {card}: eager TP step {tp_ms:.3f} ms, model-1 step {one_ms:.3f} ms; "
          f"local Adam update ({kernel['local_params']} parameters, {len(shapes)} leaves, "
          f"{kernel['launches_per_step']} tables) eagerly {kernel['ms']:.4f} ms (host-bound), replayed "
          f"from a CUDA graph {graphed['kernel']:.4f} ms vs bound {kernel['bound_ms']:.4f} ms "
          f"({100 * kernel['bound_ms'] / graphed['kernel']:.1f}%); Adam(fused=True) eagerly "
          f"{kernel['library_ms']:.4f} ms, replayed (capturable=True) {graphed['library']:.4f} ms")
    return dict(forward_max_abs_err=fwd_err, losses=losses, reference_losses=ref_losses,
                loss_max_abs_err=loss_err, counts=[r["counts"] for r in ranks],
                step_ms_tp=tp_ms, step_ms_model_1=one_ms, pair_wall_s=wall_s, kernel=kernel,
                local_params=ranks[0]["local_params"],
                snapshots={k: v for k, v in snapshots.items() if k != "launches"},
                launches={**{f"native {TF_NAME} model 2 rank {i} (phase 25)": r["launches"][f32]
                             for i, r in enumerate(ranks)}, **snapshots["launches"]})


# phase 25's snapshot legs, in the same rank processes after (a)-(d), each
# in a process group of its own (one store a group, TP25_GROUPS in all):
# the same init, 2 epochs of 4 (8, 256) batches, one step a dispatch, a
# checkpoint each epoch and a step snapshot every 2 steps: (i) turns
# snapshots off and on, the last the straight run; (ii) a run with
# preempt@step=5 armed, its drain's SystemExit(75) caught; (iii) the step
# file's state gathered, then the auto-resumed run
TP25S_EVERY, TP25S_BATCHES, TP25S_EPOCHS, TP25S_PREEMPT = 2, 4, 2, 5
TP25S_TURNS = (False, True)
TP25_GROUPS = 4
TP25S_SCRIPT = (
    "import hashlib, shutil\n"
    "from tpuddp_torch.resilience import faults, preemption\n"
    "from tpuddp_torch.training import checkpoint as ckpt\n"
    "with open(os.path.join(work, 'snap_job.json')) as f:\n"
    "    sjob = json.load(f)\n"
    "snap = {'every_steps': sjob['every']}\n"
    "def wrap(rank, world):\n"
    "    training = dict(cfg_lib.TRAINING_DEFAULTS, **sjob['training'])\n"
    "    ddp, train, test, seed = train_native.build_training(\n"
    "        rank, world, training, 'cuda', partial(token_loaders, **sjob['loaders']),\n"
    "        cfg_lib.resolve_parallel(sjob['parallel']))\n"
    "    with np.load(os.path.join(work, 'init.npz')) as data:\n"
    "        full = {k: torch.from_numpy(data[k]) for k in data.files}\n"
    "    ddp.model.load_state_dict(tp_lib.local_state_dict(full, ddp.mesh.model_index, ddp.model_size))\n"
    "    return ddp, train, test, seed, training\n"
    "def gathered(ddp):\n"
    "    params = {k: v.cpu().numpy() for k, v in ddp.gather_params().items()}\n"
    "    named = dict(ddp.model.named_parameters())\n"
    "    for key in ('exp_avg', 'exp_avg_sq'):\n"
    "        whole = tp_lib.gather_named({n: ddp.optimizer.state[p][key] for n, p in named.items()},\n"
    "                                    ddp.mesh)\n"
    "        params.update({f'{key}/{n}': t.cpu().numpy() for n, t in whole.items()})\n"
    "    return params\n"
    "def digest(arrays):\n"
    "    h = hashlib.sha256()\n"
    "    for k in sorted(arrays):\n"
    "        h.update(k.encode())\n"
    "        h.update(np.ascontiguousarray(arrays[k]).tobytes())\n"
    "    return h.hexdigest()\n"
    "def loop(ddp, train, test, seed, training, save_dir, snapshot, resume=False):\n"
    "    for k in fused_adam.kernels.values():\n"
    "        k.reset_launches()\n"
    "    return run_training_loop(ddp, train, test, save_dir, num_epochs=training['num_epochs'],\n"
    "                             checkpoint_epoch=training['checkpoint_epoch'], base_seed=seed,\n"
    "                             scan_steps=1, snapshot=snapshot, auto_resume=resume,\n"
    "                             log=lambda *a, **k: None)\n"
    "def launches():\n"
    "    torch.cuda.synchronize()\n"
    "    return {k.symbol: k.launches for k in fused_adam.kernels.values()}\n"
    "def dump(out, name):\n"
    "    with open(os.path.join(work, f'snap_{name}_{rank}.json'), 'w') as f:\n"
    "        json.dump(out, f)\n"
    "def turns_fn(rank, world, save_dir, _):\n"
    "    turns = []\n"
    "    for i, on in enumerate(sjob['turns']):\n"
    "        args = wrap(rank, world)\n"
    "        rows = loop(*args, os.path.join(work, f'turn_{i}'), snap if on else None)\n"
    "        turns.append({'snapshot': on, 'rows': rows, 'launches': launches(),\n"
    "                      'digest': digest(gathered(args[0]))})\n"
    "    dump({'turns': turns}, 'turns')\n"
    "drained = {}\n"
    "def drain_fn(rank, world, save_dir, _):\n"
    "    args = wrap(rank, world)\n"
    "    try:\n"
    "        loop(*args, os.path.join(work, 'drain'), snap)\n"
    "    finally:\n"
    "        drained.update(step=args[0].step, launches=launches())\n"
    "def resume_fn(rank, world, save_dir, _):\n"
    "    ddp, cursors = wrap(rank, world)[0], []\n"
    "    ckpt.restore_latest(os.path.join(work, 'drain'), ddp.model, ddp.optimizer,\n"
    "                        model_size=ddp.model_size, cursor_out=cursors)\n"
    "    state = gathered(ddp)\n"
    "    if rank == 0:\n"
    "        np.savez(os.path.join(work, 'gathered_drain.npz'),\n"
    "                 **{k: v for k, v in state.items() if '/' not in k})\n"
    "        os.makedirs(os.path.join(work, 'step_file'))\n"
    "        for suffix in ('', '.sha256'):\n"
    "            shutil.copy(cursors[-1]['path'] + suffix, os.path.join(work, 'step_file'))\n"
    "    args = wrap(rank, world)\n"
    "    rows = loop(*args, os.path.join(work, 'drain'), snap, resume=True)\n"
    "    dump({'rows': rows, 'launches': launches(), 'digest': digest(gathered(args[0]))}, 'resume')\n"
    "snap_out = os.path.join(work, 'snap_out')\n"
    "spawn._worker(rank, turns_fn, 2, snap_out, {}, 'cuda', ports[1], None, (0, 1))\n"
    "os.environ['TPUDDP_FAULT'] = sjob['fault']\n"
    "faults.reload_faults()\n"
    "try:\n"
    "    spawn._worker(rank, drain_fn, 2, snap_out, {}, 'cuda', ports[2], None, (0, 1))\n"
    "    drained['exit'] = 0\n"
    "except SystemExit as e:\n"
    "    drained['exit'] = e.code\n"
    "preemption.reset_preemption()\n"
    "os.environ.pop('TPUDDP_FAULT')\n"
    "faults.reload_faults()\n"
    "dump(drained, 'drain')\n"
    "spawn._worker(rank, resume_fn, 2, snap_out, {}, 'cuda', ports[3], None, (0, 1))\n"
)
LOSS_KEYS = ("epoch", "train_loss", "train_samples", "test_loss", "test_accuracy", "test_samples")


def _epoch_losses(path: str):
    """The loss and accuracy fields of a history file's epoch rows."""
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [{k: r.get(k) for k in LOSS_KEYS} for r in rows if r.get("type") == "epoch"]


def tp_snapshot_job(root: str) -> None:
    """``snap_job.json`` of phase 25's snapshot legs, in ``root``."""
    training = dict(TP25_TRAINING, num_epochs=TP25S_EPOCHS, checkpoint_epoch=1)
    with open(os.path.join(root, "snap_job.json"), "w") as f:
        json.dump({"training": training, "parallel": {"model": TP25_MODEL},
                   "loaders": dict(TP25_LOADERS, n_batches=TP25S_BATCHES),
                   "every": TP25S_EVERY, "turns": list(TP25S_TURNS),
                   "fault": f"preempt@step={TP25S_PREEMPT}"}, f)


def tp_snapshot_checks(root: str):
    """Phase 25's snapshot legs, which the pair ran: the turns, the drain,
    the step file restored here at model 1 through the reshaper, the
    auto-resumed run; returns the figures, raises on a failed check."""
    legs = {}
    for name in ("turns", "drain", "resume"):
        legs[name] = []
        for rank in (0, 1):
            with open(os.path.join(root, f"snap_{name}_{rank}.json")) as f:
                legs[name].append(json.load(f))
    turns, drained, resumed = legs["turns"], legs["drain"], legs["resume"]
    drain_dir = os.path.join(root, "drain")
    # the file the resume started from, copied by the pair before it ran on
    kept = os.path.join(root, "step_file")
    step_files = sorted(f for f in os.listdir(kept) if f.endswith(".npz"))
    step_file = step_files[0]
    topo = ckpt.read_topology(os.path.join(kept, step_file))
    meta = ckpt.read_meta(os.path.join(kept, step_file))
    with open(os.path.join(drain_dir, "history.jsonl")) as f:
        preempts = [r for r in map(json.loads, f) if r.get("event") == "preempt"]
    # the step file restored here at world 1, model 1, reshaped on load
    restored = load_model(TF_NAME, TF_VOCAB).cuda()
    ckpt.restore_latest(kept, restored, Adam(restored.parameters(), lr=1e-3), reshard_on_mismatch=True)
    with np.load(os.path.join(root, "gathered_drain.npz")) as data:
        at_drain = {k: data[k] for k in data.files}
    model_1_diff = [k for k, v in restored.state_dict().items()
                    if not np.array_equal(v.cpu().numpy(), at_drain[k])]
    straight = len(TP25S_TURNS) - 1
    f32 = fused_adam.kernel.symbol
    steps = TP25S_EPOCHS * TP25S_BATCHES
    checks = {
        "exit 75 on both ranks, drained at one step": [d["exit"] for d in drained] == [75, 75]
            and drained[0]["step"] == drained[1]["step"] and len(preempts) == 1,
        "one v4 step file of the model-2 topology": topo["format"] == ckpt.FORMAT_VERSION
            and topo["model_size"] == TP25_MODEL and topo["mesh_shape"] == [1, TP25_MODEL]
            and meta["completed"] == 0 and "step" in meta,
        "the auto-resumed run's epoch rows are the straight run's": _epoch_losses(
            os.path.join(drain_dir, "history.jsonl")) == _epoch_losses(
            os.path.join(root, f"turn_{straight}", "history.jsonl")),
        "the resumed parameters and moments are bitwise the straight run's (both ranks)": all(
            r["digest"] == t["turns"][straight]["digest"] for r, t in zip(resumed, turns)),
        "the step file restored at model 1 through the reshaper is bitwise the gathered "
        "parameters": not model_1_diff,
        "snapshots off and on give the same parameters and moments": len(
            {t["digest"] for r in turns for t in r["turns"]}) == 1,
        "2 Adam launches an update on each rank in each turn": all(
            t["launches"][f32] == sum(t["launches"].values()) == 2 * steps
            for r in turns for t in r["turns"]),
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 25 snapshots failed {failed}: step files {step_files}, "
                         f"topology {topo}, meta {meta}, drained {drained}, preempt rows {preempts}, "
                         f"model-1 keys that differ {model_1_diff}, digests "
                         f"{[[t['digest'][:12] for t in r['turns']] for r in turns]} vs "
                         f"{[r['digest'][:12] for r in resumed]}")
    medians = {}
    for on in (False, True):  # the second epoch's steps of each turn, rank 0
        ms = [v for t in turns[0]["turns"] if t["snapshot"] == on for v in t["rows"][-1]["step_ms"]]
        medians["on" if on else "off"] = statistics.median(ms)
    card = card_line()
    phase("25 snapshots", f"{TF_NAME} at parallel.model {TP25_MODEL}, {TP25S_EPOCHS} epochs of "
          f"{TP25S_BATCHES} batches, a step snapshot every {TP25S_EVERY}: preempt@step={TP25S_PREEMPT} "
          f"-> exit 75 on both ranks at step {drained[0]['step']} (epoch {preempts[0]['epoch']}), "
          f"{step_file} (v{topo['format']}, model_size {topo['model_size']}, mesh "
          f"{topo['mesh_shape']}); auto-resumed: epoch rows and the digest of parameters and moments "
          f"({resumed[0]['digest'][:16]}) bitwise the straight run; the file at model 1 through the "
          f"reshaper bitwise the gathered parameters; card {card}")
    phase("25 snapshot times", f"card {card}: step median (second epoch, rank 0, turns "
          f"{'/'.join('on' if t else 'off' for t in TP25S_TURNS)}) snapshots off "
          f"{medians['off']:.3f} ms, on {medians['on']:.3f} ms (ratio "
          f"{medians['on'] / medians['off']:.3f})")
    launches = {f"native {TF_NAME} model 2 snapshot turn {i} {'on' if on else 'off'} rank {r} "
                f"(phase 25)": turns[r]["turns"][i]["launches"][f32]
                for i, on in enumerate(TP25S_TURNS) for r in (0, 1)}
    launches.update({f"native {TF_NAME} model 2 drained rank {r} (phase 25)":
                     drained[r]["launches"][f32] for r in (0, 1)})
    launches.update({f"native {TF_NAME} model 2 resumed rank {r} (phase 25)":
                     resumed[r]["launches"][f32] for r in (0, 1)})
    return dict(step_file=step_file, topology={k: topo[k] for k in ("format", "world_size",
                                                                      "model_size", "mesh_shape")},
                drained_step=drained[0]["step"], drained_epoch=preempts[0]["epoch"],
                step_ms_median_snapshot_off=medians["off"],
                step_ms_median_snapshot_on=medians["on"], digest=resumed[0]["digest"],
                launches=launches)


class _Mesh25:
    """Model rank 0 of a (1, 2) world, for the shard's shapes (no group)."""

    model, data, model_index, data_index = TP25_MODEL, 1, 0, 0


# ---------------------------------------------------------------- phase 26 --
# serving: the request engine over AlexNet (the tutorial's model, 224 px, 10
# classes) restored from a native checkpoint, and the decode engine over
# transformer_small at full width, both from the port's serving settings
# file; 64 requests of 1-4 rows from 2 tenants; 32 prompts of 1-192 tokens
# from 4 tenants, 64 greedy tokens each
SETTINGS_SERVING = os.path.join(CONFIGS, "cifar10_alexnet_serving_h100.yaml")
SV_REQUESTS, SV_TENANTS, SV_MAX_ROWS, SV_CPU_CHECKS = 64, 2, 4, 4
SV_CPU_TOL = 1e-4  # rtol and atol of the card's served logits (TF32 off) against the CPU forward
DC_PROMPTS, DC_TENANTS, DC_MAX_PROMPT = 32, 4, 192
DC_SOLO, DC_FULL = 4, 2  # streams re-run alone; streams held against repeated full forwards
DC_KILL_STEP, DC_POISON_STEP = 40, 30  # the faults' decode steps (1-based, per engine)
DC_POISON_PROMPTS = 8
DC_TIME_STEPS = 50
ENTRY_DEMO, ENTRY_SERVE_S = 16, 30


def _serving_settings():
    """The serving file's ``serving`` block and its ``decode`` sub-block."""
    serving = cfg_lib.serving_config(cfg_lib.load_settings(SETTINGS_SERVING))
    return serving, cfg_lib.decode_config(serving)


def _launch_counts():
    return {k.symbol: k.launches for k in fused_adam.kernels.values()}


def serving_requests(root: str):
    """26 serving: the file's serving block over a native AlexNet
    checkpoint of a seeded init, restored through the integrity path on
    cuda:0; 64 seeded requests of 1-4 rows from 2 tenants submitted at
    once. Every request's logits bitwise a direct forward of its padded
    batch on the card, 4 within SV_CPU_TOL of the CPU forward, no rejects."""
    cfg, _ = _serving_settings()
    save_dir = os.path.join(root, "alexnet_ckpt")
    model = seeded_model(cfg["model"], cfg["num_classes"], cfg["input_shape"], 26)
    t0 = time.perf_counter()
    ckpt.save_on_main(save_dir, 0, model, None, 0)
    save_s = time.perf_counter() - t0
    cfg.update(checkpoint_dir=save_dir)
    t0 = time.perf_counter()
    engine = ServingEngine.from_config(cfg, out_dir=os.path.join(root, "serving"),
                                       devices=[torch.device("cuda", 0)])
    restore_s = time.perf_counter() - t0
    batches = []
    form = engine.scheduler.form
    engine.scheduler.form = lambda reqs: batches.append(form(reqs)) or batches[-1]
    t0 = time.perf_counter()
    engine.start()
    warm_s = time.perf_counter() - t0
    rng = np.random.RandomState(26)
    shape = tuple(cfg["input_shape"])
    xs = [rng.randn(int(rng.randint(1, SV_MAX_ROWS + 1)), *shape).astype(np.float32)
          for _ in range(SV_REQUESTS)]
    reset_counts()
    mark = engine.stats.mark()
    results = [engine.submit(f"tenant{i % SV_TENANTS}", x) for i, x in enumerate(xs)]
    outs = [r.result(timeout=300) for r in results]
    window = engine.stats.since(mark)
    torch.cuda.synchronize()
    launches = _launch_counts()
    summary = engine.drain(reason="chip_smoke")
    master = engine.pool.model  # the host copy the replicas were made from
    direct = engine.pool.replicas[0].model  # the replica's weights, driven here on the default stream
    bitwise, served_rows = True, 0
    with torch.inference_mode():
        for b in batches:
            ref = direct(torch.from_numpy(b.x).cuda()).cpu().numpy()
            for r, (lo, hi) in zip(b.requests, b.slices):
                bitwise &= bool(np.array_equal(r.result.result(), ref[lo:hi]))
                served_rows += hi - lo
        cpu_err, cpu_ok = 0.0, True
        for x, out in list(zip(xs, outs))[:SV_CPU_CHECKS]:
            ref = master(torch.from_numpy(x)).numpy()
            cpu_err = max(cpu_err, float(np.abs(out - ref).max()))
            cpu_ok &= bool(np.allclose(out, ref, rtol=SV_CPU_TOL, atol=SV_CPU_TOL))
    errors, n = schema.validate_history_file(os.path.join(root, "serving", "history.jsonl"))
    checks = {
        "every request's logits bitwise a direct forward of its padded batch": bitwise,
        f"every row served once ({sum(len(x) for x in xs)})": served_rows == sum(len(x) for x in xs),
        f"{SV_CPU_CHECKS} requests within {SV_CPU_TOL} of the CPU forward": cpu_ok,
        "finite logits of (rows, 10)": all(np.isfinite(o).all() and o.shape == (len(x), 10)
                                           for o, x in zip(outs, xs)),
        "no rejects": not summary["rejected"] and summary["completed"] == SV_REQUESTS,
        "the restored epoch 0": engine.pool.restored_epoch == 0,
        "history.jsonl valid": not errors and n > 0,
        "no Adam launch": not any(launches.values()),
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 26 serving failed {failed}: summary {summary}, CPU max |d| {cpu_err}, "
                         f"history errors {errors[:5]}")
    occupancy = window["batch_occupancy"]
    phase("26 serving", f"ServingEngine over {cfg['model']}@224 (10 classes) on cuda:0, restored from a "
          f"native checkpoint (saved {save_s:.2f} s, pool built and restored {restore_s:.2f} s, buckets "
          f"{engine.scheduler.buckets} warmed {warm_s:.2f} s); {SV_REQUESTS} requests of 1-{SV_MAX_ROWS} rows "
          f"({window['rows']} rows) from {SV_TENANTS} tenants at once: {window['batches']} batches, "
          f"{window['rows_per_sec']} images/s, {window['throughput_rps']} requests/s, e2e latency p50 "
          f"{window['e2e_ms']['p50']} ms p99 {window['e2e_ms']['p99']} ms (device p50 "
          f"{window['device_ms']['p50']} ms), batch occupancy {occupancy}; logits bitwise a direct forward "
          f"of each padded batch; CPU max |d| {cpu_err:.3g} (rtol/atol {SV_CPU_TOL}); no rejects")
    return dict(window=window, batches=window["batches"], save_s=save_s, restore_s=restore_s,
                warm_s=warm_s, cpu_max_abs_err=cpu_err, launches=launches)


def _decode_engine(dcfg: dict, devices, out_dir=None):
    return DecodeEngine.from_config(dict(dcfg, num_replicas=len(devices)), out_dir=out_dir,
                                     devices=devices).start()


def _prompts(dcfg: dict, n: int, seed: int):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, dcfg["vocab_size"], size=int(rng.randint(1, DC_MAX_PROMPT + 1))).astype(np.int32)
            for _ in range(n)]


def _decode_all(engine, prompts, tenants: int = DC_TENANTS):
    results = [engine.submit(f"tenant{i % tenants}", p) for i, p in enumerate(prompts)]
    return [np.asarray(r.result(timeout=600)) for r in results]


def _events26(path: str):
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["type"] == "event"]


def _step_ms(replica, dcfg):
    """ms of one replayed step (the static inputs copied in, the graph
    replayed, the logits fetched) and of the same step run eagerly on the
    replica's stream, in turns, over the drained replica's pools (all-zero
    tables: the writes go to garbage block 0)."""
    s, mb = replica.cache.max_slots, replica.cache.max_blocks
    tables, zeros = np.zeros((s, mb), np.int32), np.zeros((s,), np.int32)
    dev = lambda a: torch.from_numpy(a).cuda()

    def eager():
        with torch.cuda.stream(replica.stream):
            logits, _, _ = replica.model.decode_step(replica.kpool, replica.vpool, dev(tables), dev(zeros),
                                                     dev(zeros))
            logits.cpu()

    def replay():
        replica._step(replica.kpool, replica.vpool, tables, zeros, zeros)

    times = {"replay": [], "eager": []}
    for _ in range(DC_TIME_STEPS):
        for name, fn in (("replay", replay), ("eager", eager)):
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def serving_decode(root: str):
    """26 decode: the file's serving.decode block (transformer_small at full
    width, 8 slots, 129 blocks of 16, greedy, 64 new tokens) on cuda:0; 32
    seeded prompts of 1-192 tokens from 4 tenants at once. Checks: 4 streams
    re-run alone bitwise, 2 against repeated full forwards on the card, one
    capture and then replays only; two replicas on [cuda:0, cuda:0] under
    replica_kill@step=N bitwise the undisturbed streams with
    session_failover events; a pool_poison rebuilt, captured again,
    bitwise; a poisoned replica's next dispatch raises."""
    _, dcfg = _serving_settings()
    card = torch.device("cuda", 0)
    prompts = _prompts(dcfg, DC_PROMPTS, 26)
    out = os.path.join(root, "decode")
    reset_counts()
    t0 = time.perf_counter()
    engine = _decode_engine(dcfg, [card], out)
    start_s = time.perf_counter() - t0
    replica = engine.replicas[0]
    captures_at_start = replica.captures
    peak, stop = [0.0], threading.Event()

    def watch():
        while not stop.is_set():
            peak[0] = max(peak[0], engine.kv_occupancy())
            time.sleep(0.0005)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    mark = engine.stats.mark()
    streams = _decode_all(engine, prompts)
    window = engine.stats.since(mark)
    stop.set()
    watcher.join()
    solo = [np.asarray(engine.submit("solo", prompts[i]).result(timeout=600)) for i in range(DC_SOLO)]
    launches = _launch_counts()
    summary = engine.drain(reason="chip_smoke")
    replays, steps = replica.replays, replica.steps
    step_ms = _step_ms(replica, dcfg)
    model = replica.model
    full = {}
    with torch.inference_mode():
        for i in range(DC_FULL):
            seq, toks = torch.from_numpy(prompts[i]).long().cuda(), []
            for _ in range(len(streams[i])):
                toks.append(int(model(seq[None])[0, -1].argmax()))
                seq = torch.cat([seq, seq.new_tensor([toks[-1]])])
            full[i] = toks
    # two replicas on the one card, the first killed mid-sweep
    out2 = os.path.join(root, "decode_kill")
    killed = _with_env({"TPUDDP_FAULT": f"replica_kill@step={DC_KILL_STEP}"},
                       lambda: _run_engine(dcfg, [card, card], out2, prompts))
    # one replica whose pools are poisoned mid-sweep
    out3 = os.path.join(root, "decode_poison")
    poisoned = _with_env({"TPUDDP_FAULT": f"pool_poison@step={DC_POISON_STEP}"},
                         lambda: _run_engine(dcfg, [card], out3, prompts[:DC_POISON_PROMPTS]))
    # a poisoned replica's next dispatch raises; rebuilt, it serves again
    probe = poisoned["engine"].replicas[0]
    probe.poison()
    s, mb = probe.cache.max_slots, probe.cache.max_blocks
    zeros = np.zeros((s,), np.int32)
    try:
        probe._step(probe.kpool, probe.vpool, np.zeros((s, mb), np.int32), zeros, zeros)
        raised = False
    except RuntimeError:
        raised = True
    probe.rebuild()
    probe.canary(poisoned["engine"].buckets)
    failovers = [e for e in _events26(os.path.join(out2, "history.jsonl")) if e["event"] == "session_failover"]
    poison_events = [e["event"] for e in _events26(os.path.join(out3, "history.jsonl"))]
    errors = [schema.validate_history_file(os.path.join(d, "history.jsonl"))[0] for d in (out, out2, out3)]
    checks = {
        f"{DC_SOLO} streams re-run alone bitwise": all(np.array_equal(a, b) for a, b in zip(solo, streams)),
        f"{DC_FULL} streams those of repeated full forwards": all(full[i] == streams[i].tolist()
                                                                  for i in range(DC_FULL)),
        "every stream 64 tokens": all(len(t) == dcfg["max_new_tokens"] for t in streams),
        "one capture at start, then replays only": captures_at_start == 1 and replica.captures == 1
        and replays == steps > 0,
        "replica_kill: every stream bitwise the undisturbed run": all(
            np.array_equal(a, b) for a, b in zip(killed["streams"], streams)),
        "replica_kill: session_failover events, the replica recovered": bool(failovers)
        and sum(r.recoveries for r in killed["engine"].replicas) == 1 and killed["fired"],
        "pool_poison: bitwise, rebuilt, captured again": all(
            np.array_equal(a, b) for a, b in zip(poisoned["streams"], streams[:DC_POISON_PROMPTS]))
        and probe.recoveries == 1 and poisoned["captures"] == 2 and poisoned["fired"],
        "a poisoned replica's next dispatch raises": raised and probe.captures == 3,
        "no rejects": not summary["rejected"],
        "history.jsonl valid (3 runs)": not any(errors),
        "no Adam launch": not any(launches.values()),
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 26 decode failed {failed}: summary {summary}, failovers {failovers}, "
                         f"poison events {poison_events}, killed {killed['summary']}, errors {errors}")
    phase("26 decode", f"DecodeEngine over {dcfg['model']} (d 128, 8 heads, 4 layers, 256 positions, vocab "
          f"256) on cuda:0, {dcfg['max_slots']} slots, {dcfg['kv_blocks']} blocks of {dcfg['kv_block_size']}, "
          f"started (9 prefill buckets + capture) in {start_s:.2f} s; {DC_PROMPTS} prompts of 1-{DC_MAX_PROMPT} "
          f"tokens from {DC_TENANTS} tenants at once, {dcfg['max_new_tokens']} greedy tokens each: "
          f"{window['tokens_per_sec']} tokens/s, TTFT p50 {window['ttft_ms']['p50']} ms p99 "
          f"{window['ttft_ms']['p99']} ms, ITL p50 {window['itl_ms']['p50']} ms p99 {window['itl_ms']['p99']} ms, "
          f"peak KV occupancy {peak[0]:.4f}; {replica.captures} capture, {replays} replays for "
          f"{steps} steps; a step replayed {step_ms['replay']:.4f} ms vs eager {step_ms['eager']:.4f} ms "
          f"(inputs in, logits out); {DC_SOLO} solo re-runs bitwise, {DC_FULL} streams = full forwards; "
          f"replica_kill@step={DC_KILL_STEP} on [cuda:0, cuda:0]: {len(failovers)} session_failover events, "
          f"every stream bitwise; pool_poison@step={DC_POISON_STEP}: rebuilt, captured again, bitwise")
    return dict(window=window, peak_kv_occupancy=peak[0], start_s=start_s, step_ms=step_ms,
                captures=replica.captures, replays=replays, steps=steps,
                failovers=len(failovers), kill_summary=killed["summary"], launches=launches)


def _run_engine(dcfg, devices, out_dir, prompts):
    engine = _decode_engine(dcfg, devices, out_dir)
    streams = _decode_all(engine, prompts)
    summary = engine.drain(reason="chip_smoke")
    return dict(engine=engine, streams=streams, summary=summary,
                captures=engine.replicas[0].captures,
                fired=all(s.fired for s in faults.active_faults()))


def serving_entry(root: str):
    """26 entry: ``python -m tpuddp_torch.serving --decode --demo 16 --serve
    30`` on the serving settings file (out_dir in ``root``); SIGTERM once
    it prints "demo traffic complete; serving": exit 75, the last line the
    JSON summary with all 16 sequences finished, history.jsonl valid."""
    settings = cfg_lib.load_settings(SETTINGS_SERVING)
    d = os.path.join(root, "entry")
    settings["out_dir"] = d
    path = os.path.join(root, "entry.yaml")
    with open(path, "w") as f:
        json.dump(settings, f)  # JSON is YAML
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("TPUDDP_FAULT", None)
    t0 = time.perf_counter()
    p = subprocess.Popen([sys.executable, "-u", "-m", "tpuddp_torch.serving", "--decode", "--demo",
                          str(ENTRY_DEMO), "--serve", str(ENTRY_SERVE_S), "--settings", path],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(180, p.kill)
    watchdog.start()
    lines, t_sig = [], None
    try:
        for line in p.stdout:
            lines.append(line)
            if t_sig is None and line.startswith("demo traffic complete; serving"):
                t_sig = time.perf_counter()
                p.send_signal(signal.SIGTERM)
        p.wait(timeout=120)
    finally:
        watchdog.cancel()
        if p.poll() is None:
            p.kill()
            p.wait()
    out = [ln for ln in lines if ln.strip()]
    try:
        summary = json.loads(out[-1])
    except (IndexError, ValueError):
        summary = {}
    errors, n = schema.validate_history_file(os.path.join(d, "history.jsonl"))
    checks = {
        "SIGTERM sent after the demo": t_sig is not None,
        "exit 75": p.returncode == preemption.EXIT_PREEMPTED,
        f"the last line the JSON summary, {ENTRY_DEMO} sequences finished": summary.get("completed")
        == ENTRY_DEMO and summary.get("submitted") == ENTRY_DEMO,
        "history.jsonl valid": not errors and n > 0,
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: 26 entry failed {failed}: exit {p.returncode}, errors {errors[:5]}: "
                         f"{''.join(lines)[-3000:]}")
    phase("26 entry", f"python -m tpuddp_torch.serving --decode --demo {ENTRY_DEMO} --serve {ENTRY_SERVE_S} "
          f"(cifar10_alexnet_serving_h100.yaml): SIGTERM {t_sig - t0:.2f} s after the start, "
          f"{summary['in_flight_at_drain']} sequences in flight; exit {p.returncode}, "
          f"{summary['completed']} sequences finished, {summary['tokens']} tokens, history.jsonl valid "
          f"({n} records)")
    return dict(exit=p.returncode, start_to_sigterm_s=t_sig - t0, summary=summary)


def serving_phase():
    """Phase 26: the request engine, the decode engine and the entry point
    on the card, each with the Adam kernels' counts set to 0 just before
    and read just after (serving runs no optimizer: 0)."""
    root = tempfile.mkdtemp(prefix="tpuddp_torch_serving_")
    try:
        requests = serving_requests(root)
        torch.cuda.empty_cache()
        decode = serving_decode(root)
        entry = serving_entry(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {}
    for label, run in (("serving alexnet", requests), (f"decode {TF_NAME}", decode)):
        for sym, n in run.pop("launches").items():
            launches.setdefault(sym, {})[f"{label} (phase 26)"] = n
    return dict(requests=requests, decode=decode, entry=entry, launches=launches)


# ---------------------------------------------------------------- phase 27 --
# the fleet: `python -m tpuddp_torch.fleet chaos-demo` cut for one card (the
# port's launcher takes one process a GPU, so every job runs at world 1 on
# cuda:0 and the pool counts three slots): two digits_h100.yaml training jobs
# cut to short epochs with a checkpoint each, one toy_mlp serving job of up to
# 2 replicas on cuda:0, one late arrival of priority 100; the SIGKILL resume,
# one endorsed tuner action through drain and relaunch, the displacement
# through the drain (never SIGKILL first), the serving job autoscaled 1 -> 2,
# every history valid, every job in its own run dir; each training attempt's
# Adam launches as the job itself reports them
FLEET_TIMEOUT_S = 420


def fleet_phase():
    """Phase 27: the chaos demo on the card; its figures and each training
    attempt's Adam launches."""
    from tpuddp_torch.fleet import __main__ as fleet_cli

    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="tpuddp_torch_fleet_")
    t0 = time.perf_counter()
    try:
        summary = fleet_cli.run_chaos_demo(os.path.join(root, "fleet"), device="cuda",
                                           timeout=FLEET_TIMEOUT_S)
    except fleet_cli.ChaosCheckFailure as e:
        raise SystemExit(f"chip_smoke: 27 fleet failed: {e}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall_s = time.perf_counter() - t0
    f32 = fused_adam.kernel.symbol
    launches = {f"native digits fleet {job} attempt {i} (phase 27)": attempt[f32]
                for job, attempts in summary["adam_launches"].items()
                for i, attempt in enumerate(attempts)}
    card = card_line()
    phase("27 fleet", f"chaos demo on one card (pool {summary['pool']} slots, every job at world 1 on "
          f"cuda:0): supervisor histories {summary['supervisor_history']}; autoscaler "
          f"{[(a['job'], a['action'], a['world']) for a in summary['autoscaler_actions']]} over "
          f"{summary['scrapes']['tried']} scrapes ({summary['scrapes']['live']} live), "
          f"{summary['proposals']} proposal(s); tuner {summary['tuner_counters']}; epochs "
          f"{summary['epochs']}; every history valid; Adam launches by attempt {launches}")
    phase("27 times", f"card {card}: SIGKILL -> resumed header {summary['sigkill_to_resumed_header_s']:.3f} s, "
          f"-> resumed first epoch {summary['sigkill_to_resumed_epoch_s']:.3f} s; tuner SIGTERM -> exit "
          f"75 {summary['tune_sigterm_to_exit_75_s']:.3f} s, -> relaunched header "
          f"{summary['tune_sigterm_to_relaunched_header_s']:.3f} s, -> its first epoch "
          f"{summary['tune_sigterm_to_relaunched_epoch_s']:.3f} s; displacement SIGTERM -> exit 75 "
          f"{summary['displace_sigterm_to_exit_75_s']:.3f} s; scale-up -> the 2-replica header "
          f"{summary['scale_up_to_scaled_header_s']:.3f} s; demo wall {wall_s:.1f} s")
    return dict(**{k: v for k, v in summary.items() if k != "adam_launches"}, wall_s=wall_s,
                launches=launches)


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
    t18 = time.perf_counter()
    remat_18 = remat_phase()
    phase_18_s = time.perf_counter() - t18
    t19 = time.perf_counter()
    telemetry_19 = telemetry_phase(remat_18["entry"]["plain"])
    phase_19_s = time.perf_counter() - t19
    t20 = time.perf_counter()
    preempt_20 = preempt_phase()
    phase_20_s = time.perf_counter() - t20
    t21 = time.perf_counter()
    elastic_21 = elastic_phase()
    phase_21_s = time.perf_counter() - t21
    t22 = time.perf_counter()
    snap_22 = snapshot_world2_phase()
    phase_22_s = time.perf_counter() - t22
    t23 = time.perf_counter()
    live_23 = live_phase()
    phase_23_s = time.perf_counter() - t23
    t24 = time.perf_counter()
    tf_24 = transformer_phase(bw, flops)
    phase_24_s = time.perf_counter() - t24
    t25 = time.perf_counter()
    tp_25 = tensor_parallel_phase(bw, flops)
    phase_25_s = time.perf_counter() - t25
    t26 = time.perf_counter()
    serving_26 = serving_phase()
    phase_26_s = time.perf_counter() - t26
    t27 = time.perf_counter()
    fleet_27 = fleet_phase()
    phase_27_s = time.perf_counter() - t27
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
    print(json.dumps({"remat": {
        **{k: v for k, v in remat_18.items() if k != "launches"}, "phase_18_s": phase_18_s,
    }}))
    print(json.dumps({"telemetry": {**telemetry_19["runs"], "phase_19_s": phase_19_s}}))
    print(json.dumps({"preempt": {
        **{k: v for k, v in preempt_20.items() if k != "launches"}, "phase_20_s": phase_20_s,
    }}))
    print(json.dumps({"elastic": {
        **{k: v for k, v in elastic_21.items() if k != "launches"}, "phase_21_s": phase_21_s,
    }}))
    print(json.dumps({"snapshots_world_2": {
        **{k: v for k, v in snap_22.items() if k != "launches"}, "phase_22_s": phase_22_s,
    }}))
    print(json.dumps({"live_plane": {
        **{k: v for k, v in live_23.items() if k != "launches"}, "phase_23_s": phase_23_s,
    }}))
    print(json.dumps({"transformer": {
        **{k: tf_24[k] for k in ("forward", "decode", "steps", "leaves", "flops_per_step")},
        "training": {k: v for k, v in tf_24["training"].items() if k != "launches"},
        "adam_transformer_small": tf_24["kernel"], "phase_24_s": phase_24_s,
    }}))
    print(json.dumps({"tensor_parallel": {
        **{k: v for k, v in tp_25.items() if k != "launches"}, "phase_25_s": phase_25_s,
    }}))
    print(json.dumps({"serving": {
        **{k: v for k, v in serving_26.items() if k != "launches"}, "phase_26_s": phase_26_s,
    }}))
    print(json.dumps({"fleet": {
        **{k: v for k, v in fleet_27.items() if k != "launches"}, "phase_27_s": phase_27_s,
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
    phase_18 = remat_18["launches"]
    phase_19 = telemetry_19["launches"]
    phase_20 = preempt_20["launches"]
    phase_21 = elastic_21["launches"]
    phase_22 = snap_22["launches"]
    phase_23 = live_23["launches"]
    phase_24 = {**tf_24["training"]["launches"],
                f"native {TF_NAME} chunks (phase 24)": tf_24["steps"]["launches"]}
    phase_25 = tp_25["launches"]
    phase_26 = serving_26["launches"][f32_sym]
    phase_27 = fleet_27["launches"]
    phase_26_bf16 = serving_26["launches"][bf16_sym]
    by_path = {"native": launches_f32, "toy_cnn sync_bn": launches_toy,
               "managed": launches_managed, "managed accum 2": launches_accum,
               **{f"native pipeline {k}": n for k, n in ab_f32.items()},
               **{f"toy_cnn pipeline {k}": n for k, n in ab_toy.items()},
               "native resumed": resume_native, "managed resumed": resume_managed, **phase_8,
               "native digits": launches_digits, **phase_9, **phase_10, **phase_11_f32, **phase_12,
               **phase_13, **phase_14, **phase_15, **phase_16, **phase_17, **phase_18, **phase_19,
               **phase_20, **phase_21, **phase_22, **phase_23, **phase_24, **phase_25, **phase_26,
               **phase_27}
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
         "vgg16_32_leaves": {**vgg_16["kernels"][torch.float32], "launches_by_path": phase_16},
         "transformer_small_52_leaves": {**tf_24["kernel"], "launches_by_path": phase_24},
         "transformer_small_model_2_shard": {**tp_25["kernel"], "launches_by_path": phase_25}},
        {"name": KERNEL_NAMES[torch.bfloat16], **common,
         "launches": (launches_bf16 + sum(ab_bf16.values()) + sum(phase_9_bf16.values())
                      + sum(phase_10_bf16.values()) + sum(phase_11.values())
                      + sum(phase_12_bf16.values()) + sum(phase_26_bf16.values())),
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
                              **{k: 0 for k in phase_16}, **{k: 0 for k in phase_17},
                              **{k: 0 for k in phase_18}, **{k: 0 for k in phase_19},
                              **{k: 0 for k in phase_20}, **{k: 0 for k in phase_21},
                              **{k: 0 for k in phase_22}, **{k: 0 for k in phase_23},
                              **{k: 0 for k in phase_24}, **{k: 0 for k in phase_25},
                              **phase_26_bf16, **{k: 0 for k in phase_27}},
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
          f"phase 17: {phase_17_s:.1f} s, phase 18: {phase_18_s:.1f} s, phase 19: {phase_19_s:.1f} s, "
          f"phase 20: {phase_20_s:.1f} s, phase 21: {phase_21_s:.1f} s, phase 22: {phase_22_s:.1f} s, "
          f"phase 23: {phase_23_s:.1f} s, phase 24: {phase_24_s:.1f} s, phase 25: {phase_25_s:.1f} s, "
          f"phase 26: {phase_26_s:.1f} s, phase 27: {phase_27_s:.1f} s)")
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
