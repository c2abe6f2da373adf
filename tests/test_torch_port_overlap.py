"""The segmented-overlap step of the port (``comm_overlap``:
``parallel/comm.py::make_segments``, ``GradComm.exchange_segment``,
``training/step.py::SegmentedSync``, ``DistributedDataParallel.
_resolve_overlap``) against the JAX package's, on the CPU at world 1, with
inputs made from a seed with numpy:

- the plan: ``make_segments`` through the JAX package's six unit tests
  (``tests/test_overlap.py``) and on random layer sizes and caps; the
  per-child sizes of toy_mlp, toy_cnn and AlexNet in the JAX order and
  their segments at several ``bucket_cap_mb`` (AlexNet: 3 segments at 25,
  7 at 1, 2 at 100, 1 at 250); each segment's permutation is its span of
  the whole model's;
- ``comm_overlap_meta`` against the JAX wrap's for ``auto``, ``true`` and
  ``false``, under ZeRO-1 and at the single-segment cap; ``true`` on an
  ineligible run and a bad knob value are the JAX package's ``ValueError``
  texts, on the native and the managed path;
- the segmented step bitwise the barrier step for every hook, per step,
  per cycle (A = 2) and per ``train_step_many`` chunk of 4: parameters,
  BatchNorm buffers, Adam moments, the residual and the sums, with every
  segment's exchange issued from inside the backward;
- configs/digits_tpu.yaml's block (toy_cnn with sync_bn, 8 px) with
  ``int8_ef`` and ``bf16_ef`` (A = 2, ``scan_steps: 4``) against the JAX
  package's segmented run from the same weights, within ``SPREAD`` times
  the JAX package's own spread from an init one ulp higher, as
  tests/test_torch_port_comm_gloo.py holds the hooked runs;
- checkpoints: a segmented port file resumed by the JAX package's barrier
  run, whose file the port resumes, segmented and barrier bitwise alike.

On the card (``cuda``, skipped here): the segmented chunk replayed from a
CUDA graph, with its exchange on the side stream, bitwise the eager
segmented chunk and the barrier chunk.
"""

import gc
import math
import os
import shutil
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp import optim as jax_optim
from tpuddp.accelerate import Accelerator as JaxAccelerator
from tpuddp.data import ShardedDataLoader as JaxLoader
from tpuddp.models import load_model as jax_load_model
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.nn import Linear as JaxLinear
from tpuddp.parallel import comm as jax_comm
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.training import checkpoint as jax_ckpt
from tpuddp.training.loop import run_training_loop as jax_run_training_loop

from tpuddp_torch import config as cfg
from tpuddp_torch import train_native
from tpuddp_torch.accelerate import Accelerator
from tpuddp_torch.data.transforms import make_train_augment
from tpuddp_torch.models import load_model
from tpuddp_torch.models.convert import (
    JaxFlatOrder, flat_to_jax, jax_layer_sizes, jax_param_span, jax_sizes, state_dict_from_jax,
)
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.nn.layers import Linear
from tpuddp_torch.optim import Adam
from tpuddp_torch.parallel import comm
from tpuddp_torch.parallel.ddp import DistributedDataParallel
from tpuddp_torch.training.loop import run_training_loop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_torch_port_comm_gloo import BASE, CAP, SPREAD, SPREAD_LOSS_CAP, _ulp_up  # noqa: E402
from test_torch_port_optim_train import _np  # noqa: E402
from test_torch_port_zero1_gloo import _hw, _pieces, jax_init  # noqa: E402

MB = 1024 * 1024
KEY = jax.random.key(0)
ALEXNET_SEGMENTS_25 = (((0, 19), 40_222_528), ((19, 21), 16_781_312), ((21, 22), 40_970))


def cap_mb(elems: int) -> float:
    """bucket_cap_mb holding exactly ``elems`` float32 elements."""
    return elems * 4 / MB


# ------------------------------------------------------------------ plan --
# The JAX package's make_segments unit tests (tests/test_overlap.py), each
# run on the port's function and held to the JAX package's output too.

def _case_follow_bucket_aligned_layer_boundaries(make_buckets, make_segments):
    buckets = make_buckets((6, 6, 6), 24, cap_mb(12))
    segs = make_segments((6, 6, 6), buckets, 24)
    assert [s.flat for s in segs] == [(0, 12), (12, 24)]
    assert [s.layers for s in segs] == [(0, 2), (2, 3)]
    assert [s.buckets for s in segs] == [((0, 12),), ((12, 24),)]
    return segs


def _case_never_split_a_bucket(make_buckets, make_segments):
    buckets = ((0, 10), (10, 24))
    segs = make_segments((6, 6, 12), buckets, 24)
    assert len(segs) == 1 and segs[0].flat == (0, 24) and segs[0].layers == (0, 3)
    assert segs[0].buckets == buckets
    return segs


def _case_zero_param_children_attach(make_buckets, make_segments):
    buckets = make_buckets((0, 8, 0, 8), 16, cap_mb(8))
    segs = make_segments((0, 8, 0, 8), buckets, 16)
    assert [s.flat for s in segs] == [(0, 8), (8, 16)]
    covered = [s.layers for s in segs]
    assert covered[0][0] == 0 and covered[-1][1] == 4
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(covered, covered[1:]))
    return segs


def _case_tail_absorbs_padding(make_buckets, make_segments):
    buckets = make_buckets((6, 6), 16, cap_mb(6))
    segs = make_segments((6, 6), buckets, 16)
    assert segs[0].flat[0] == 0 and segs[-1].flat[1] == 16
    assert all(a.flat[1] == b.flat[0] for a, b in zip(segs, segs[1:]))
    assert sum(len(s.buckets) for s in segs) == len(buckets)
    return segs


def _case_single_bucket_is_single_segment(make_buckets, make_segments):
    segs = make_segments((6, 6, 6), ((0, 24),), 24)
    assert len(segs) == 1 and tuple(segs[0]) == ((0, 3), (0, 24), ((0, 24),))
    return segs


def _case_refuse_inconsistent_totals(make_buckets, make_segments):
    with pytest.raises(ValueError, match="layer sizes sum to 30 > padded total 24"):
        make_segments((30,), ((0, 24),), 24)
    return ()


JAX_SEGMENT_TESTS = {f.__name__[len("_case_"):]: f for f in (
    _case_follow_bucket_aligned_layer_boundaries, _case_never_split_a_bucket,
    _case_zero_param_children_attach, _case_tail_absorbs_padding,
    _case_single_bucket_is_single_segment, _case_refuse_inconsistent_totals)}


def _plain(segs):
    return [tuple(s) for s in segs]


@pytest.mark.parametrize("case", sorted(JAX_SEGMENT_TESTS))
def test_the_jax_packages_segment_tests(case):
    ours = JAX_SEGMENT_TESTS[case](comm.make_buckets, comm.make_segments)
    theirs = JAX_SEGMENT_TESTS[case](jax_comm.make_buckets, jax_comm.make_segments)
    assert _plain(ours) == _plain(theirs)


@pytest.mark.parametrize("seed", range(6))
def test_make_segments_matches_jax_on_random_layers(seed):
    rng = np.random.default_rng(seed)
    sizes = tuple(int(s) * int(rng.random() < 0.7) for s in rng.integers(1, 300_000, rng.integers(1, 25)))
    world = int(rng.choice([1, 2, 3, 8]))
    total = world * -(-sum(sizes) // world)
    cap = float(rng.choice([0.05, 0.3, 1.0, 25.0]))
    buckets = comm.make_buckets(sizes, total, cap)
    assert _plain(comm.make_segments(sizes, buckets, total)) == _plain(
        jax_comm.make_segments(sizes, buckets, total))


def _jax_layer_sizes(name, hw):
    params = jax.eval_shape(jax_load_model(name, 10).init, jax.random.key(0),
                            jnp.zeros((1, hw, hw, 3)))[0]
    return tuple(sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(sub))
                 for sub in params)


@pytest.mark.parametrize("name,hw,cap,n_segments", [
    ("alexnet", 224, 25.0, 3), ("alexnet", 224, 1.0, 7), ("alexnet", 224, 100.0, 2),
    ("alexnet", 224, 250.0, 1), ("toy_mlp", 8, 0.1, 3), ("toy_mlp", 8, 25.0, 1),
    ("toy_cnn", 8, CAP, 4), ("toy_cnn", 8, 0.05, 3), ("toy_cnn", 8, 25.0, 1),
])
def test_the_segment_plan_is_the_jax_packages(name, hw, cap, n_segments):
    """The port's per-child sizes (the JAX ``Sequential``'s children, not
    the port model's own) and the segments of the JAX bucket plan over
    them, at worlds 1, 2 and 8."""
    with torch.device("meta"):
        model = load_model(name, 10, input_shape=(hw, hw, 3))
    layer_sizes = jax_layer_sizes(name, model)
    assert layer_sizes == _jax_layer_sizes(name, hw)
    sizes = jax_sizes(name, model)
    for world in (1, 2, 8):
        total = world * -(-sum(sizes) // world)
        buckets = comm.make_buckets(sizes, total, cap)
        segs = comm.make_segments(layer_sizes, buckets, total)
        assert _plain(segs) == _plain(jax_comm.make_segments(layer_sizes, buckets, total))
        assert len(segs) == n_segments
        for seg in segs:  # whole children, so a segment gathers only its own gradients
            a, b = seg.layers
            assert sum(layer_sizes[a:b]) == seg.flat[1] - seg.flat[0] - (
                total - sum(sizes) if seg is segs[-1] else 0)
    if (name, cap) == ("alexnet", 25.0):
        world1 = comm.make_segments(layer_sizes, comm.make_buckets(sizes, sum(sizes), cap), sum(sizes))
        assert [(s.layers, s.flat[1] - s.flat[0]) for s in world1] == list(ALEXNET_SEGMENTS_25)
        # torchvision's layout: conv 1-5 and classifier.1 | classifier.4 | classifier.6
        assert [jax_param_span(name, model, s.layers) for s in world1] == [(0, 12), (12, 14), (14, 16)]


@pytest.mark.parametrize("name,cap", [("toy_cnn", CAP), ("toy_mlp", 0.1)])
def test_each_segment_order_is_its_span_of_the_whole(name, cap):
    model = load_model(name, 10, input_shape=(8, 8, 3))
    sizes = jax_sizes(name, model)
    segs = comm.make_segments(jax_layer_sizes(name, model), comm.make_buckets(sizes, sum(sizes), cap),
                              sum(sizes))
    port = torch.arange(sum(sizes), dtype=torch.float64)
    whole = flat_to_jax(name, model, port.numpy())
    ends = np.cumsum([0] + [p.numel() for p in model.parameters()])
    for seg in segs:
        order = JaxFlatOrder(name, model, layers=seg.layers)
        first, end = jax_param_span(name, model, seg.layers)
        mine = port[ends[first]:ends[end]]
        lo = seg.flat[0]
        np.testing.assert_array_equal(order.to_jax(mine).numpy(), whole[lo:lo + order.raw])
        torch.testing.assert_close(order.from_jax(order.to_jax(mine)), mine, rtol=0, atol=0)


# ------------------------------------------------------------------ meta --

def _port_ddp(name, overlap, hook="none", cap=CAP, zero1=False, accum=1, augment=None, gen=None,
              model=None):
    torch.manual_seed(0)
    model = model if model is not None else load_model(name, 10, input_shape=(8, 8, 3))
    return DistributedDataParallel(
        model, Adam(model.parameters(), lr=1e-3), CrossEntropyLoss(), device="cpu",
        comm_hook=hook, bucket_cap_mb=cap, comm_overlap=overlap, weight_update_sharding=zero1,
        grad_accumulation=accum, augment=augment, generator=gen)


def _jax_ddp(cpu_devices, name, overlap, hook="none", cap=CAP, zero1=False, model=None):
    ddp = JaxDDP(model if model is not None else jax_load_model(name, 10), jax_optim.Adam(1e-3),
                 JaxCrossEntropyLoss(), mesh=make_mesh(cpu_devices[:1]), comm_hook=hook,
                 bucket_cap_mb=cap, comm_overlap=overlap, weight_update_sharding=zero1)
    ddp.init_state(KEY, jnp.zeros((1, 8, 8, 3)))
    return ddp


META_CASES = {
    "toy_mlp auto": ("toy_mlp", "auto", "none", 0.1, False),
    "toy_mlp auto one segment": ("toy_mlp", "auto", "none", 25.0, False),
    "toy_mlp true one segment": ("toy_mlp", True, "none", 25.0, False),
    "toy_cnn auto int8_ef": ("toy_cnn", "auto", "int8_ef", CAP, False),
    "toy_cnn true bf16_ef": ("toy_cnn", True, "bf16_ef", CAP, False),
    "toy_cnn false topk_ef": ("toy_cnn", False, "topk_ef", CAP, False),
    "toy_cnn 'on' none": ("toy_cnn", "on", "none", CAP, False),
    "toy_cnn auto zero1": ("toy_cnn", "auto", "none", CAP, True),
    "toy_cnn auto zero1 bf16_ef": ("toy_cnn", "auto", "bf16_ef", CAP, True),
}


@pytest.mark.parametrize("case", sorted(META_CASES))
def test_comm_overlap_meta_is_the_jax_wraps(cpu_devices, case):
    name, overlap, hook, cap, zero1 = META_CASES[case]
    ours = _port_ddp(name, overlap, hook, cap, zero1).comm_overlap_meta
    theirs = _jax_ddp(cpu_devices, name, overlap, hook, cap, zero1).comm_overlap_meta
    assert ours == theirs


def _raised(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_true_under_zero1_is_the_jax_value_error(cpu_devices):
    ours = _raised(lambda: _port_ddp("toy_cnn", True, "int8_ef", zero1=True))
    theirs = _raised(lambda: _jax_ddp(cpu_devices, "toy_cnn", True, "int8_ef", zero1=True))
    assert ours == theirs and "weight_update_sharding" in ours


def test_a_model_without_a_sequential_counterpart(cpu_devices):
    """A model the JAX package has no ``Sequential`` for: ``auto`` keeps the
    barrier step with its reason, ``true`` is its ValueError."""
    ours = _port_ddp(None, "auto", model=Linear(192, 10)).comm_overlap_meta
    theirs = _jax_ddp(cpu_devices, None, "auto", model=JaxLinear(10)).comm_overlap_meta
    assert ours == theirs and "Linear has no child decomposition" in ours["reason"]
    assert _raised(lambda: _port_ddp(None, True, model=Linear(192, 10))) == _raised(
        lambda: _jax_ddp(cpu_devices, None, True, model=JaxLinear(10)))


@pytest.mark.parametrize("value", ("always", 2, "maybe"))
def test_a_bad_knob_value_is_the_jax_value_error(cpu_devices, value):
    theirs = _raised(lambda: JaxDDP(jax_load_model("toy_mlp", 10), jax_optim.Adam(1e-3),
                                    JaxCrossEntropyLoss(), mesh=make_mesh(cpu_devices[:1]),
                                    comm_overlap=value))
    assert _raised(lambda: _port_ddp("toy_mlp", value)) == theirs
    assert _raised(lambda: cfg.training_config({"training": {"comm_overlap": value}})) == theirs
    assert _raised(lambda: Accelerator(device="cpu", comm_overlap=value)) == theirs


def test_the_managed_path_keeps_the_barrier_step(cpu_devices):
    mesh = make_mesh(cpu_devices[:1])
    assert _raised(lambda: Accelerator(device="cpu", comm_overlap=True)) == _raised(
        lambda: JaxAccelerator(mesh=mesh, comm_overlap=True))
    for value in ("auto", False):
        assert Accelerator(device="cpu", comm_overlap=value).comm_overlap_meta == JaxAccelerator(
            mesh=mesh, comm_overlap=value).comm_overlap_meta
    assert cfg.training_config({"training": {"comm_overlap": True}})["comm_overlap"] is True


# --------------------------------------------------------------- bitwise --

def _batches(n, rows=16, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (rows, 8, 8, 3), dtype=np.uint8),
             rng.integers(0, 10, rows), (rng.random(rows) < 0.9).astype(np.float32)) for _ in range(n)]


def _state(ddp):
    """Parameters, buffers, optimizer state, the residual, and the last
    update's gradients (Adam's steps are nearly blind to a gradient's last
    bits; the gradients are not)."""
    out = {f"model/{k}": v.detach().clone() for k, v in ddp.model.state_dict().items()}
    out.update({f"grad/{k}": p.grad.clone() for k, p in ddp.model.named_parameters()
                if p.grad is not None})
    for i, st in enumerate(ddp.optimizer.state.values()):
        out.update({f"opt{i}/{k}": v.clone() for k, v in st.items() if torch.is_tensor(v)})
    if ddp.residual is not None:
        out["residual"] = ddp.residual.clone()
    return out


def _train(ddp, batches, mode):
    if mode == "chunk of 4":
        return ddp.train_step_many(batches[:4], ddp.train_step_many(batches[4:]))
    if mode == "cycle":
        sums = torch.zeros(2)
        for i in range(0, len(batches), 2):
            sums = sums + ddp.train_cycle(batches[i:i + 2])
        return sums
    sums = torch.zeros(2)
    for b in batches:
        sums = sums + ddp.train_step(b)
    return sums


@pytest.mark.parametrize("hook", comm.COMM_HOOKS)
@pytest.mark.parametrize("mode", ("step", "cycle", "chunk of 4"))
def test_the_segmented_step_is_bitwise_the_barrier_step(hook, mode):
    """toy_cnn (four segments at 2 KB buckets) with flips: 8 micro-batches,
    from one init; every segment exchanged from inside the backward."""
    torch.set_num_threads(2)
    batches = _batches(8)
    out = {}
    for overlap in (True, False):
        gen = torch.Generator().manual_seed(2)
        ddp = _port_ddp("toy_cnn", overlap, hook, accum=2 if mode == "cycle" else 1,
                        augment=make_train_augment(size=None, flip=True, generator=gen), gen=gen)
        sums = _train(ddp, batches, mode)
        out[overlap] = (_state(ddp), sums)
        if overlap:
            segments = ddp.comm_overlap_meta["segments"]
            updates = 4 if mode == "cycle" else 8
            assert segments == 4 and ddp._overlap.counts == {"hook": segments * updates, "join": 0}
    (seg, seg_sums), (barrier, barrier_sums) = out[True], out[False]
    assert sorted(seg) == sorted(barrier) and ("residual" in seg) == (hook in comm.EF_HOOKS)
    for k in barrier:
        torch.testing.assert_close(seg[k], barrier[k], rtol=0, atol=0, msg=k)
    torch.testing.assert_close(seg_sums, barrier_sums, rtol=0, atol=0)


def test_a_frozen_parameter_is_exchanged_as_zeros():
    """A parameter that does not train lands no gradient and counts as
    zeros in the exchange, as in the barrier step. The first conv is
    segment 0 alone (layer 0 ends on a bucket edge), so that segment is
    exchanged at the join; the other three from the backward."""
    torch.set_num_threads(2)
    out = {}
    for overlap in (True, False):
        ddp = _port_ddp("toy_cnn", overlap, "int8_ef", augment=make_train_augment(size=None, flip=False))
        next(ddp.model.parameters()).requires_grad_(False)
        _train(ddp, _batches(3), "step")
        out[overlap] = _state(ddp)
        if overlap:
            assert ddp._overlap.counts == {"hook": 9, "join": 3}
    for k in out[False]:
        torch.testing.assert_close(out[True][k], out[False][k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("hook", comm.COMM_HOOKS[1:])
def test_the_join_exchanges_what_did_not_land(hook):
    """Gradients set outside a backward (one of them None): the join
    exchanges every segment, last first, bitwise ``comm_sync``."""
    torch.set_num_threads(2)
    grads = {}
    for overlap in (True, False):
        ddp = _port_ddp("toy_cnn", overlap, hook)
        gen = torch.Generator().manual_seed(5)
        for i, p in enumerate(ddp.model.parameters()):
            p.grad = None if i == 2 else torch.randn(p.shape, generator=gen)
        if overlap:
            ddp._overlap.arm()
            ddp._overlap.join()
            assert ddp._overlap.counts == {"hook": 0, "join": 4}
        else:
            ddp.sync_grads()
        grads[overlap] = [p.grad.clone() for p in ddp.model.parameters()] + (
            [] if ddp.residual is None else [ddp.residual.clone()])
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_a_dropped_wrap_frees_its_model_without_the_collector():
    """The gradient hooks hold the segmented exchange weakly: no reference
    cycle keeps a dropped wrap's model (on the card, its memory and its
    graphs) alive until a garbage collection."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        for overlap in (False, True):  # (the process's first optimizer keeps a frame)
            ddp = _port_ddp("toy_cnn", overlap, "int8_ef", augment=make_train_augment(size=None, flip=False))
            _train(ddp, _batches(2), "step")
            model = weakref.ref(ddp.model)
            del ddp
        assert model() is None
    finally:
        if collecting:
            gc.enable()


# -------------------------------------------------------- against JAX ----

RUNS = {
    "int8_ef": dict(BASE, comm_hook="int8_ef", bucket_cap_mb=CAP, scan_steps=1),
    "bf16_ef_accum_scan": dict(BASE, comm_hook="bf16_ef", bucket_cap_mb=CAP,
                               gradient_accumulation_steps=2, scan_steps=4),
}


def jax_segmented(training, params, mstate, devices, overlap=True):
    """The JAX package's native run of ``training`` from ``params``/
    ``mstate`` (segmented: ``comm_overlap`` true): ``(per-epoch losses,
    final state_dict, residual, comm_overlap_meta)``."""
    mesh, train, test, augment, eval_transform, model, opt = _pieces(training, devices)
    ddp = JaxDDP(model, opt, JaxCrossEntropyLoss(), mesh=mesh, augment=augment,
                 eval_transform=eval_transform, grad_accumulation=training["gradient_accumulation_steps"],
                 comm_hook=training["comm_hook"], bucket_cap_mb=CAP, comm_overlap=overlap)
    hw = _hw(training)
    state = ddp.init_state(KEY, jnp.zeros((1, hw, hw, 3)), params=params, model_state=mstate)
    state, history = jax_run_training_loop(
        ddp, state, JaxLoader(train, training["train_batch_size"], mesh, shuffle=True),
        JaxLoader(test, training["test_batch_size"], mesh, shuffle=True), None,
        num_epochs=training["num_epochs"], scan_steps=training["scan_steps"], log=lambda *_: None)
    return ([(r["train_loss"], r["test_loss"]) for r in history],
            state_dict_from_jax("toy_cnn", _np(state.params), _np(state.model_state)),
            np.asarray(state.comm_state), ddp.comm_overlap_meta)


def port_run(training, init_sd, save_dir=None, resume=False):
    """The native entry point's objects on ``training`` at world 1, from
    ``init_sd``: ``(ddp, history)``."""
    ddp, train_loader, test_loader, seed = train_native.build_training(0, 1, training, "cpu")
    if init_sd is not None:
        ddp.model.load_state_dict(init_sd)
    history = run_training_loop(
        ddp, train_loader, test_loader, save_dir, num_epochs=training["num_epochs"],
        checkpoint_epoch=training["checkpoint_epoch"], base_seed=seed, auto_resume=resume,
        scan_steps=training["scan_steps"], log=lambda *_: None)
    return ddp, history


@pytest.fixture(scope="module")
def init():
    return jax_init(BASE)


@pytest.mark.parametrize("case", sorted(RUNS))
def test_the_segmented_run_matches_the_jax_segmented_run(cpu_devices, init, case):
    """2 digits epochs: losses, parameters and buffers, the residual."""
    torch.set_num_threads(2)
    training = RUNS[case]
    params, mstate, sd = init
    ddp, history = port_run(training, sd)
    ref = jax_segmented(training, params, mstate, cpu_devices[:1])
    alt = jax_segmented(training, _ulp_up(params), mstate, cpu_devices[:1])
    assert ddp.comm_overlap_meta == ref[3] == {"enabled": True, "segments": 4, "reason": None}
    ours = np.array([(r["train_loss"], r["test_loss"]) for r in history])
    theirs, other = np.array(ref[0]), np.array(alt[0])
    final = {k: v.numpy() for k, v in ddp.model.state_dict().items()}
    spread = {"losses": float(np.max(np.abs(other / theirs - 1))),
              "state": max(float(np.abs(alt[1][k].numpy() - ref[1][k].numpy()).max()) for k in ref[1]),
              "residual": float(np.abs(alt[2] - ref[2]).max())}
    got = {"losses": float(np.max(np.abs(ours / theirs - 1))),
           "state": max(float(np.abs(final[k] - ref[1][k].numpy()).max()) for k in ref[1]),
           "residual": float(np.abs(ddp.residual.numpy() - ref[2]).max())}
    detail = {k: (got[k], spread[k]) for k in got}
    assert 0 < spread["losses"] < SPREAD_LOSS_CAP and 0 < spread["state"], detail
    for k in got:
        assert got[k] <= SPREAD * spread[k], f"{case}: (port, JAX spread) {detail}"


# ----------------------------------------------------------- checkpoints --

def _arrays(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def test_a_segmented_file_resumes_into_the_jax_barrier_run_and_back(tmp_path, cpu_devices, init):
    """Epoch 1: the port, segmented; its file restored by the JAX package's
    barrier wrap (every array, the residual included), which trains epoch
    2; its file restored by the port, segmented and barrier, each training
    epoch 3: the two files bitwise, so the residual means one thing to
    both steps and both packages."""
    torch.set_num_threads(2)
    training = dict(RUNS["int8_ef"], checkpoint_epoch=1)
    params, mstate, sd = init
    port_dir = tmp_path / "port"
    ddp, _ = port_run(dict(training, num_epochs=1), sd, str(port_dir))
    assert ddp.comm_overlap_meta["enabled"]
    port_file = _arrays(port_dir / "ckpt_0.npz")
    np.testing.assert_array_equal(port_file[".comm_state"], ddp.residual.numpy())

    jax_dir = tmp_path / "jax"
    shutil.copytree(port_dir, jax_dir)
    mesh, train, test, augment, eval_transform, model, opt = _pieces(training, cpu_devices[:1])
    jddp = JaxDDP(model, opt, JaxCrossEntropyLoss(), mesh=mesh, augment=augment,
                  eval_transform=eval_transform, comm_hook="int8_ef", bucket_cap_mb=CAP,
                  comm_overlap=False)
    like = jddp.init_state(KEY, jnp.zeros((1, 8, 8, 3)))
    assert jddp.comm_overlap_meta["reason"] == "disabled"
    restored, next_epoch = jax_ckpt.restore_latest(str(jax_dir), like, world_size=1)
    assert next_epoch == 1
    np.testing.assert_array_equal(np.asarray(restored.comm_state), port_file[".comm_state"])
    np.testing.assert_array_equal(np.asarray(restored.params[0]["weight"]), port_file[".params[0]['weight']"])
    _, history = jax_run_training_loop(
        jddp, like, JaxLoader(train, 32, mesh, shuffle=True), JaxLoader(test, 45, mesh, shuffle=True),
        str(jax_dir), num_epochs=2, checkpoint_epoch=1, auto_resume=True, log=lambda *_: None)
    assert [r["epoch"] for r in history] == [1] and math.isfinite(history[0]["train_loss"])

    files = {}
    for overlap in (True, False):
        run_dir = tmp_path / f"back_{overlap}"
        shutil.copytree(jax_dir, run_dir)
        back, history = port_run(dict(training, num_epochs=3, comm_overlap=overlap), None,
                                 str(run_dir), resume=True)
        assert [r["epoch"] for r in history] == [2]
        assert back.comm_overlap_meta["enabled"] is overlap
        files[overlap] = _arrays(run_dir / "ckpt_2.npz")
    jax_file = _arrays(jax_dir / "ckpt_1.npz")
    assert np.any(jax_file[".comm_state"] != port_file[".comm_state"])
    assert sorted(files[True]) == sorted(files[False])
    for k in files[False]:
        np.testing.assert_array_equal(files[True][k], files[False][k], err_msg=k)


# ---------------------------------------------------------- on the card --

@pytest.fixture()
def card():
    """The GPU, with cuDNN's deterministic algorithms as the entry points
    run them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("hook", comm.COMM_HOOKS)
def test_the_side_stream_capture_is_bitwise_eager_and_barrier(card, hook):
    """3 chunks of 4 toy_cnn steps (A = 2 for bf16_ef) segmented through
    CUDA-graph replay (the exchange on the wrap's side stream, forked and
    joined inside the capture), segmented eagerly and barrier eagerly: the
    state, the residual and the sums, bitwise."""
    accum = 2 if hook == "bf16_ef" else 1
    batches = _batches(12)
    out = {}
    for overlap, replay in ((True, True), (True, False), (False, False)):
        torch.manual_seed(0)
        model = load_model("toy_cnn", 10, input_shape=(8, 8, 3))
        gen = torch.Generator().manual_seed(2)
        ddp = DistributedDataParallel(
            model, Adam(model.parameters(), lr=1e-3), CrossEntropyLoss(), device="cuda",
            comm_hook=hook, bucket_cap_mb=CAP, comm_overlap=overlap, grad_accumulation=accum,
            augment=make_train_augment(size=None, flip=True, generator=gen), generator=gen)
        ddp._graph_replay = replay
        assert (ddp._overlap is not None and ddp._overlap.stream is not None) is overlap
        sums = None
        for c in range(3):
            sums = ddp.train_step_many(batches[4 * c:4 * (c + 1)], sums)
        torch.cuda.synchronize()
        out[(overlap, replay)] = (_state(ddp), sums.clone())
    ref, ref_sums = out[(False, False)]
    for key in ((True, True), (True, False)):
        got, sums = out[key]
        for k in ref:
            torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0, msg=f"{key} {k}")
        torch.testing.assert_close(sums, ref_sums, rtol=0, atol=0)
