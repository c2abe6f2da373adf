"""The native path's ``scan_steps`` and the managed evaluator's K-batch
groups in the port (tpuddp_torch.training.loop, parallel/ddp.py,
accelerate.FusedEvaluator), on the CPU, against the JAX package:

- K: the port's ``resolve_scan_steps`` against the JAX function over a grid
  of depths, batch counts, parameter bytes and batch bytes; the rounding
  under accumulation (inline in ``tpuddp/training/loop.py:250-270``)
  against the numbers that code gives;
- the dispatch plan of a pass against what the JAX ``pipeline.run_pass``
  dispatches (its kind, steps and real steps per dispatch);
- on the CPU a chunked epoch is bitwise the per-batch one, flip masks
  included (the generator's state after the epoch);
- the FusedEvaluator's groups against the JAX evaluator on a ragged stream:
  the depth per batch shape and the sums.

Then, marked ``cuda`` (skipped here, ``pytest -m cuda`` on the card): a
native chunk's CUDA-graph replay against its eager chunk, and an eval group
replay against its eager group, bitwise. Training against the JAX native
loop at ``scan_steps: 4`` is in tests/test_torch_port_scan_train.py (1
process) and tests/test_torch_port_scan_gloo.py (2 processes).

Tolerances: the evaluator's loss sum rtol 1e-4 against the JAX package
(float32 sums in another order); counts, depths and plans exact; the CPU
pairs bitwise."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp import nn as jax_nn
from tpuddp.accelerate import Accelerator as JaxAccelerator
from tpuddp.accelerate import FusedEvaluator as JaxFusedEvaluator
from tpuddp.models import ToyMLP as JaxToyMLP
from tpuddp.parallel import make_mesh
from tpuddp.training import pipeline as jax_pipeline
from tpuddp.training.loop import resolve_scan_steps as jax_resolve_scan_steps
from tpuddp.utils import batching as jax_batching

from tpuddp_torch import optim
from tpuddp_torch.accelerate import Accelerator, FusedEvaluator
from tpuddp_torch.data import ShardedDataLoader
from tpuddp_torch.data.synthetic import SyntheticClassification
from tpuddp_torch.data.transforms import make_train_augment
from tpuddp_torch.models import AlexNet, ToyCNN, ToyMLP
from tpuddp_torch.models.convert import jax_leaf_index, state_dict_from_jax
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.nn.norm import convert_sync_batchnorm
from tpuddp_torch.ops import fused_adam
from tpuddp_torch.parallel.ddp import DistributedDataParallel
from tpuddp_torch.training import loop
from tpuddp_torch.utils import batching

MIB = 1024 * 1024
SHAPE, WIDTHS = (8, 8, 3), (4, 8)


# ------------------------------------------------------------------- K ----

@pytest.mark.parametrize("n_batches", [1, 7, 45, 391])
@pytest.mark.parametrize("scan_steps", ["auto", 1, 8, 64])
def test_resolve_scan_steps_is_the_jax_packages(scan_steps, n_batches):
    """Parameter bytes under and over 4 MiB and unknown; batch bytes
    unknown, small (one CIFAR-10 batch of 128) and over the 256 MiB
    budget."""
    for param_bytes in (1 * MIB, 228 * MIB, None):
        for batch_nbytes in (None, 128 * 3072, 300 * MIB):
            args = (scan_steps, n_batches, param_bytes, batch_nbytes)
            assert loop.resolve_scan_steps(*args) == jax_resolve_scan_steps(*args), args


@pytest.mark.parametrize("bad", [0, -3, "0"])
def test_scan_steps_under_one_raise_in_both_packages(bad):
    for fn in (loop.resolve_scan_steps, jax_resolve_scan_steps):
        with pytest.raises(ValueError, match="scan_steps must be >= 1"):
            fn(bad, 10)


# (K, A, batch bytes) -> K in whole cycles, as tpuddp/training/loop.py:250-270
# computes it: max(A, K // A * A); over the budget, max(A, budget // bytes // A
# * A), with a warning when even that is over the budget
CYCLE_CASES = [
    ((1, 1, None), 1), ((64, 1, 300 * MIB), 64),
    ((1, 2, None), 2), ((7, 2, None), 6), ((8, 2, None), 8), ((64, 2, 128 * 3072), 64),
    ((8, 2, 100 * MIB), 2), ((64, 2, 40 * MIB), 6),
    ((1, 3, None), 3), ((8, 3, None), 6), ((64, 3, None), 63), ((64, 3, 128 * 3072), 63),
    ((9, 3, 100 * MIB), 3), ((64, 3, 30 * MIB), 6),
]


@pytest.mark.parametrize("args,want", CYCLE_CASES, ids=[str(c[0]) for c in CYCLE_CASES])
def test_scan_steps_in_whole_cycles_are_the_jax_packages(args, want, caplog):
    with caplog.at_level(logging.WARNING, logger="tpuddp"):
        assert loop.scan_steps_in_cycles(*args) == want
    k, accum, nbytes = args
    over = accum > 1 and bool(nbytes) and want * nbytes > batching.STAGE_BYTES_BUDGET
    assert ("over the ~256 MB staging budget" in caplog.text) == over


# --------------------------------------------------------- dispatch plan --

class _RecordingDDP:
    """What JAX ``run_pass`` asks of a ddp: identity placements."""

    def shard(self, batch):
        return batch

    def shard_stacked(self, stacked):
        return stacked


def _jax_plan(n, k, accum):
    batches = [(np.full((2,), i, np.float32), np.zeros(2, np.int32), np.ones(2, np.float32))
               for i in range(n)]
    plan = []

    def one(state, batch):
        plan.append(("one", 1, int(batch[2].sum() > 0)))
        return state, np.zeros(())

    def many(state, stacked):
        ws = stacked[2]
        plan.append(("many", len(ws), int((ws.sum(axis=1) > 0).sum())))
        return state, np.zeros(())

    jax_pipeline.run_pass(_RecordingDDP(), None, batches, k, one, many, accum=accum)
    return plan


def _port_plan(n, k, accum):
    batches = [(torch.full((2,), float(i)), torch.zeros(2, dtype=torch.int64), torch.ones(2))
               for i in range(n)]
    plan = []
    for many, chunk in loop.dispatches(iter(batches), k, accum):
        real = sum(int(w.sum() > 0) for _, _, w in chunk)
        plan.append(("many" if many else "one", len(chunk), real))
        if many:  # a padding batch repeats the last real one, weighted 0
            for x, _, w in chunk[real:]:
                assert torch.equal(x, chunk[real - 1][0]) and not w.any()
    return plan


@pytest.mark.parametrize("accum", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 4])
def test_dispatch_plan_is_what_jax_run_pass_dispatches(k, accum):
    """N = 1, K - 1, K, 2K + 3 batches, with K in whole cycles as the loop
    rounds it."""
    k_cycles = loop.scan_steps_in_cycles(k, accum)
    for n in sorted({1, k - 1, k, 2 * k + 3}):
        want = _jax_plan(n, k_cycles, accum)
        assert _port_plan(n, k_cycles, accum) == want, (n, k_cycles, accum)
        assert sum(real for _, _, real in want) == n
        if accum > 1:
            assert all(kind == "many" and steps % accum == 0 for kind, steps, _ in want)


# ------------------------------------------------ chunked == per batch --

def _native_run(scan_steps, accum, epochs=2):
    """toy_cnn with sync_bn and flips on 90 rows in batches of 7 (13
    batches, the last ragged; 5 test batches), one process on the CPU."""
    torch.manual_seed(0)
    model = convert_sync_batchnorm(ToyCNN(10, WIDTHS, input_shape=SHAPE))
    gen = torch.Generator().manual_seed(5)
    ddp = DistributedDataParallel(
        model, optim.Adam(model.parameters(), lr=1e-2), CrossEntropyLoss(),
        augment=make_train_augment(size=None, flip=True, mean=(0.5,) * 3, std=(0.25,) * 3,
                                   generator=gen),
        device="cpu", grad_accumulation=accum, generator=gen,
    )
    calls = {"many": 0, "eval many": 0}
    many, eval_many = ddp.train_step_many, ddp.eval_step_many

    def counted(fn, name):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    ddp.train_step_many = counted(many, "many")
    ddp.eval_step_many = counted(eval_many, "eval many")
    train, test = SyntheticClassification(n=120, shape=SHAPE, seed=7).split(30)
    history = loop.run_training_loop(
        ddp, ShardedDataLoader(train, 7, 0, 1, shuffle=True), ShardedDataLoader(test, 7, 0, 1),
        save_dir=None, num_epochs=epochs, scan_steps=scan_steps, log=lambda *_: None,
    )
    state = [t.clone() for t in model.state_dict().values()]
    state += [t.clone() for st in ddp.optimizer.state.values() for t in st.values()
              if torch.is_tensor(t)]
    return history, state, gen.get_state(), ddp.step, calls


@pytest.mark.parametrize("accum", [1, 2], ids=["A1", "A2"])
def test_chunked_epochs_are_bitwise_the_per_batch_ones(accum):
    """``scan_steps: 4`` against ``scan_steps: 1``: the epoch rows, the
    parameters, buffers and optimizer state, the micro-batch count and the
    flip generator's state after 2 epochs, bitwise; the chunked run made
    its chunks through ``train_step_many``/``eval_step_many`` and the
    per-batch run none."""
    torch.set_num_threads(2)
    h1, s1, g1, step1, calls1 = _native_run(1, accum)
    h4, s4, g4, step4, calls4 = _native_run(4, accum)
    keys = ("train_loss", "test_loss", "test_accuracy", "train_samples", "test_samples")
    assert [[r[k] for k in keys] for r in h4] == [[r[k] for k in keys] for r in h1]
    assert len(s1) == len(s4) and all(torch.equal(a, b) for a, b in zip(s1, s4))
    assert torch.equal(g1, g4)
    # 13 batches a epoch; A = 2 pads the last cycle with one micro-batch
    assert step1 == step4 == 2 * (13 + (accum - 1))
    assert calls1 == {"many": 0, "eval many": 0}
    assert calls4 == {"many": 2 * (3 if accum == 1 else 4), "eval many": 2}
    for r1, r4 in zip(h1, h4):
        assert len(r1["step_ms"]) == len(r4["step_ms"]) == -(-13 // accum)
        assert (r4["scan_steps"], r4["eval_scan_steps"]) == (4, 4)
        assert (r1["scan_steps"], r1["eval_scan_steps"]) == (accum, 1)


def test_step_clock_spreads_a_dispatch_over_its_updates():
    """A chunk of 4 updates after 2 single steps: 6 entries, the chunk's
    time split evenly."""
    clock = loop.StepClock(torch.device("cpu"))
    clock.marks = [0.0, 0.002, 0.003, 0.011]
    clock.groups = [1, 1, 4]
    np.testing.assert_allclose(clock.step_ms(), [2.0, 1.0, 2.0, 2.0, 2.0, 2.0])


def test_chunk_flip_masks_are_the_per_step_draws():
    """The chunk's masks come from the augment's generator in step order,
    as K single steps draw them."""
    x = torch.zeros(5, 8, 8, 3)
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    augments = [make_train_augment(size=None, flip=True, generator=g) for g in gens]
    model = ToyMLP(8 * 8 * 3, 10, (4,))
    ddp = DistributedDataParallel(model, optim.SGD(model.parameters(), 0.1), CrossEntropyLoss(),
                                  augment=augments[0], device="cpu")
    masks = ddp._flip_masks([(x, None, None)] * 3)
    for m in masks:
        assert torch.equal(m, augments[1].flip_mask(x))
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    ddp.augment = make_train_augment(size=None, flip=False)
    assert ddp._flip_masks([(x, None, None)] * 3) == [None] * 3


def test_train_step_many_refuses_a_partial_cycle():
    model = ToyMLP(8 * 8 * 3, 10, (4,))
    ddp = DistributedDataParallel(model, optim.SGD(model.parameters(), 0.1), CrossEntropyLoss(),
                                  device="cpu", grad_accumulation=2)
    batch = (np.zeros((4, 8, 8, 3), np.float32), np.zeros(4, np.int64), np.ones(4, np.float32))
    with pytest.raises(ValueError, match="whole cycles of 2"):
        ddp.train_step_many([batch] * 3)


# ------------------------------------------------------- FusedEvaluator --

def test_fused_evaluator_groups_match_jax_on_a_ragged_stream(monkeypatch):
    """A ragged stream of 8-, 3- and 5-row batches (4, 6, 4 of them, then
    one of 8 rows again) under a staging budget of two 8-row batches: the
    auto depth per batch shape (2, 5, 3) is the JAX evaluator's, worked out
    again at each shape; the groups flush on each shape change and at
    finalize; the sums are the JAX evaluator's and bitwise the ungrouped
    ones (``fuse_steps=1``)."""
    budget = 2 * 8 * 8 * 8 * 3 * 4
    monkeypatch.setattr(batching, "STAGE_BYTES_BUDGET", budget)
    monkeypatch.setattr(jax_batching, "STAGE_BYTES_BUDGET", budget)
    rng = np.random.RandomState(3)
    rows = [8] * 4 + [3] * 6 + [5] * 4 + [8]
    stream = [(rng.randn(n, 8, 8, 3).astype(np.float32), rng.randint(0, 10, n),
               (rng.rand(n) < 0.8).astype(np.float32)) for n in rows]
    jmodule = JaxToyMLP(10, hidden=(16,))
    params, mstate = jmodule.init(jax.random.key(0), jnp.zeros((1, 8, 8, 3)))

    def port(fuse_steps=None):
        acc = Accelerator(seed=0, device="cpu")
        module = ToyMLP(8 * 8 * 3, 10, (16,))
        module.load_state_dict(state_dict_from_jax(
            "toy_mlp", jax.tree_util.tree_map(np.asarray, params), None))
        model = acc.prepare(module)
        return FusedEvaluator(model, CrossEntropyLoss(), fuse_steps=fuse_steps)

    ev = port()
    groups = []
    flush = ev._flush
    ev._flush = lambda: (groups.append(len(ev._queue)), flush())
    depths = []
    for x, y, w in stream:
        ev.add(x, y, w)
        if ev._queue:
            depths.append(ev._resolve_fuse())
    result = ev.finalize()

    jacc = JaxAccelerator(mesh=make_mesh(jax.devices("cpu")[:1]), seed=0)
    jmodule._tpuddp_initial_variables = (params, mstate)
    jmodel = jacc.prepare(jmodule)
    jmodel(np.zeros((1, 8, 8, 3), np.float32))
    jmodel.eval()
    jev = JaxFusedEvaluator(jmodel, jax_nn.CrossEntropyLoss())
    jgroups, jdepths = [], []
    jflush = jev._flush
    jev._flush = lambda: (jgroups.append(len(jev._queue)), jflush())
    for x, y, w in stream:
        jev.add(x, y, w)
        if jev._queue:
            jdepths.append(jev._resolve_fuse())
    ref = jev.finalize()

    assert depths == jdepths and sorted(set(depths)) == [2, 3, 5]
    assert [g for g in groups if g] == [g for g in jgroups if g] == [2, 2, 5, 1, 3, 1, 1]
    assert result[1:] == ref[1:] and result[2] == int(sum(w.sum() for _, _, w in stream))
    np.testing.assert_allclose(result[0], ref[0], rtol=1e-4)
    one = port(fuse_steps=1)
    for x, y, w in stream:
        one.add(x, y, w)
    assert one.finalize() == result


def test_fused_evaluator_flushes_queued_train_steps_before_its_group():
    """A group sees the updates of train steps queued before it ran."""
    acc = Accelerator(seed=0, fuse_steps=4, device="cpu")
    torch.manual_seed(0)
    module = ToyMLP(8 * 8 * 3, 10, (8,))
    model, opt = acc.prepare(module, optim.SGD(module.parameters(), 0.5))
    x, y = np.random.RandomState(0).randn(6, 8, 8, 3).astype(np.float32), np.arange(6) % 10
    criterion = CrossEntropyLoss()
    ev = FusedEvaluator(model, criterion, fuse_steps=2)
    ev.add(x, y)
    for _ in range(2):
        opt.zero_grad()
        loss = criterion(model(x), y)
        acc.backward(loss)
        opt.step()
    assert opt.queued == 2
    ev.add(x, y)  # fills the group: the two train steps run first
    assert opt.queued == 0
    after = FusedEvaluator(model, criterion, fuse_steps=1)
    after.add(x, y)
    after.add(x, y)
    assert ev.finalize() == after.finalize()


# ------------------------------------------------------------ on the card --

@pytest.fixture()
def card():
    """The GPU, with cuDNN's deterministic algorithms as the entry points
    run (``train_native.set_numerics``): with cuDNN's default choice two
    identical eager runs of toy_cnn can part, and no replay could be held
    bitwise against them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = deterministic


def _card_batches(n, rows, hw, seed):
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randint(0, 256, (rows, hw, hw, 3), dtype=torch.uint8, generator=gen).numpy(),
             torch.randint(0, 10, (rows,), generator=gen).numpy(),
             (torch.rand(rows, generator=gen) < 0.9).float().numpy()) for _ in range(n)]


def _native_pair(make, opt_name, k, accum=1, chunks=3, rows=16, hw=8):
    """``chunks`` chunks of ``k`` batches through ``train_step_many`` from
    one state, replayed and eager (``_graph_replay = False``): the state
    after them, the sums, the Adam launches and the graph counts of each."""
    from tpuddp_torch.training import graphs

    batches = _card_batches(k * chunks, rows, hw, seed=1)
    out = {}
    for replay in (False, True):
        torch.manual_seed(0)
        model, augment, gen = make()
        if opt_name == "lars":
            opt = optim.LARS(model.parameters(), lr=0.1, momentum=0.9, weight_decay=5e-4)
        else:
            bf16 = opt_name == "adam_bf16"
            leaf = jax_leaf_index("toy_cnn", model) if bf16 else None
            opt = optim.Adam(model.parameters(), lr=1e-3,
                             state_dtype=torch.bfloat16 if bf16 else None,
                             leaf_index=[leaf[n] for n, _ in model.named_parameters()] if bf16 else None)
        ddp = DistributedDataParallel(model, opt, CrossEntropyLoss(), augment=augment, device="cuda",
                                      grad_accumulation=accum, generator=gen)
        ddp._graph_replay = replay
        torch.cuda.manual_seed(7)  # dropout: one stream for both runs
        for kern in fused_adam.kernels.values():
            kern.reset_launches()
        graphs.reset_stats()
        sums = None
        for c in range(chunks):
            sums = ddp.train_step_many(batches[c * k:(c + 1) * k], sums)
        torch.cuda.synchronize()
        state = [t.detach().clone() for t in model.state_dict().values()]
        state += [t.clone() for st in opt.state.values() for t in st.values() if torch.is_tensor(t)]
        out[replay] = (state, sums.clone(), sum(kn.launches for kn in fused_adam.kernels.values()),
                       dict(graphs.stats), ddp.step)
    (s_e, sums_e, n_e, _, step_e), (s_r, sums_r, n_r, g, step_r) = out[False], out[True]
    assert all(torch.equal(a, b) for a, b in zip(s_e, s_r)) and len(s_e) == len(s_r)
    assert torch.equal(sums_e, sums_r)
    updates = chunks * k // accum
    assert n_e == n_r == (0 if opt_name == "lars" else updates)
    assert (g["captures"], g["replays"]) == (1, chunks - 1)
    assert step_e == step_r == chunks * k


def _toy(flip=False):
    def make():
        gen = torch.Generator().manual_seed(2)
        model = convert_sync_batchnorm(ToyCNN(10, WIDTHS, input_shape=SHAPE))
        return model, make_train_augment(size=None, flip=flip, generator=gen), gen
    return make


@pytest.mark.cuda
@pytest.mark.parametrize("opt_name", ["adam", "adam_bf16", "lars"])
def test_native_chunk_replay_is_bitwise_its_eager_chunk_on_the_card(card, opt_name):
    """toy_cnn with sync_bn and flips, 3 chunks of 4: parameters, buffers,
    optimizer state and sums bitwise; 1 capture, 2 replays; one launch of
    the moments' kernel per update (none with LARS)."""
    _native_pair(_toy(flip=True), opt_name, 4)


@pytest.mark.cuda
def test_native_cycle_chunk_replay_is_bitwise_its_eager_chunk_on_the_card(card):
    """A = 2 at K = 4: 3 chunks of two cycles, 6 updates."""
    _native_pair(_toy(flip=True), "adam", 4, accum=2)


@pytest.mark.cuda
def test_native_alexnet_chunk_replay_with_flips_and_dropout_on_the_card(card):
    """AlexNet at 64 px with flips and dropout, 3 chunks of 4."""
    def make():
        gen = torch.Generator().manual_seed(2)
        return AlexNet(num_classes=10), make_train_augment(size=64, flip=True, generator=gen), gen

    _native_pair(make, "adam", 4, rows=8, hw=32)


@pytest.mark.cuda
def test_eval_group_replay_is_bitwise_its_eager_group_on_the_card(card):
    """3 groups of 4 eval batches through ``eval_step_many`` and 3 managed
    FusedEvaluator groups: replayed against eager, bitwise; 1 capture, 2
    replays each."""
    from tpuddp_torch.data.transforms import make_eval_transform
    from tpuddp_torch.training import graphs

    batches = _card_batches(12, 16, 8, seed=3)
    out = {}
    for replay in (False, True):
        torch.manual_seed(0)
        model = ToyCNN(10, WIDTHS, input_shape=SHAPE)
        ddp = DistributedDataParallel(model, optim.Adam(model.parameters()), CrossEntropyLoss(),
                                      eval_transform=make_eval_transform(size=None), device="cuda")
        ddp._graph_replay = replay
        graphs.reset_stats()
        sums = None
        for c in range(3):
            sums = ddp.eval_step_many(batches[4 * c:4 * c + 4], sums)
        out[replay] = (sums.clone(), dict(graphs.stats["by_kind"]))
    assert torch.equal(out[False][0], out[True][0])
    assert (out[True][1]["eval"]["captures"], out[True][1]["eval"]["replays"]) == (1, 2)

    results = {}
    for fuse in (1, 4):
        acc = Accelerator(seed=0)
        torch.manual_seed(0)
        model = acc.prepare(ToyCNN(10, WIDTHS, input_shape=SHAPE))
        ev = FusedEvaluator(model, CrossEntropyLoss(), transform=make_eval_transform(size=None),
                            fuse_steps=fuse)
        graphs.reset_stats()
        for x, y, w in batches:
            ev.add(x, y, w)
        results[fuse] = (ev.finalize(), dict(graphs.stats["by_kind"]))
    assert results[1][0] == results[4][0]
    g = results[4][1]["managed eval"]
    assert (g["captures"], g["replays"]) == (1, 2) and "managed eval" not in results[1][1]
