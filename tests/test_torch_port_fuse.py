"""The managed path's fused steps and FusedEvaluator in the port
(tpuddp_torch.accelerate, training/graphs.py's host side,
ops/device_scalars.py), on the CPU: one counterpart of each fuse test of
tests/test_accelerate.py (the evaluator against the eager eval loop and the
JAX package's evaluator, the dropped-loss refusal, flushes on reads of
parameters and losses, the failed flush, exclusivity with accumulation, the
auto depth and its staging budget, the short epoch's single partial flush,
restore discarding the queue, the evaluator's depth on ragged streams); then
the host side of a CUDA-graph replay that the CPU can reach: the per-step
words each optimizer hands a replay, and the step-time groups.

On the CPU a flush runs its steps eagerly, so a fused step is bitwise the
unfused one (asserted here step by step; the 6-epoch run is in
tests/test_torch_port_fuse_train.py). Tolerances: the evaluator's loss sum
rtol 1e-5 against the per-batch host sum (float32 against float64
accumulation), rtol 1e-4 against the JAX package; counts exact."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp import nn as jax_nn
from tpuddp import optim as jax_optim
from tpuddp.accelerate import Accelerator as JaxAccelerator
from tpuddp.accelerate import FusedEvaluator as JaxFusedEvaluator
from tpuddp.accelerate import _resolve_auto_fuse
from tpuddp.data import DataLoader as JaxDataLoader
from tpuddp.data.synthetic import SyntheticClassification as JaxSynthetic
from tpuddp.data.transforms import make_eval_transform as jax_eval_transform
from tpuddp.models import ToyMLP as JaxToyMLP
from tpuddp.parallel import make_mesh

from tpuddp_torch import optim
from tpuddp_torch.accelerate import AUTO_FUSE_CAP, Accelerator, FusedEvaluator, sum_losses
from tpuddp_torch.data import DataLoader
from tpuddp_torch.data.synthetic import SyntheticClassification
from tpuddp_torch.data.transforms import make_eval_transform
from tpuddp_torch.models import ToyMLP
from tpuddp_torch.models.convert import state_dict_from_jax
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.ops import device_scalars, fused_adam
from tpuddp_torch.training.loop import StepClock
from tpuddp_torch.utils import batching

HW = 4


def _batch(seed=0, n=8):
    rng = np.random.RandomState(seed)
    return rng.randn(n, HW, HW, 3).astype(np.float32), rng.randint(0, 10, n)


def _prepared(fuse, seed=1, lr=0.5, opt="sgd"):
    acc = Accelerator(seed=seed, fuse_steps=fuse, device="cpu")
    torch.manual_seed(seed)
    module = ToyMLP(HW * HW * 3, 10, (8,))
    optimizer = (optim.SGD(module.parameters(), lr) if opt == "sgd"
                 else optim.Adam(module.parameters(), lr=lr))
    model, opt = acc.prepare(module, optimizer)
    return acc, model, opt


def _params(model):
    return [p.detach().clone() for p in model._module.parameters()]


def _steps(acc, model, opt, n, criterion=None, seed=0):
    criterion = criterion or CrossEntropyLoss()
    x, y = _batch(seed)
    losses = []
    for _ in range(n):
        opt.zero_grad()
        loss = criterion(model(x), y)
        acc.backward(loss)
        opt.step()
        losses.append(loss)
    return losses


# ------------------------------------------------------- FusedEvaluator --

def test_fused_evaluator_matches_eager_eval():
    """tests/test_accelerate.py:202: the evaluator (K = 4) reproduces the
    eager eval loop, a padded last batch and a remainder group below K
    included, and the JAX package's evaluator on the same weights; a second
    pass starts from zero."""
    ds = SyntheticClassification(n=52, shape=(8, 8, 3), seed=2)
    jmodule = JaxToyMLP(10, hidden=(16,))
    params, mstate = jmodule.init(jax.random.key(0), jnp.zeros((1, 8, 8, 3)))
    acc = Accelerator(seed=0, device="cpu")
    module = ToyMLP(8 * 8 * 3, 10, (16,))
    module.load_state_dict(state_dict_from_jax(
        "toy_mlp", jax.tree_util.tree_map(np.asarray, params), None))
    model = acc.prepare(module)
    model.eval()
    criterion, transform = CrossEntropyLoss(), make_eval_transform(size=None)
    loader = DataLoader(ds, batch_size=8)  # 7 batches, the last one padded

    loss_sum = correct = total = 0
    for x, y, w in loader:
        outputs = model(transform(model.to_device(x)))
        loss_sum += criterion(outputs, y, w).item()
        right = (outputs.argmax(dim=-1).numpy() == y) & (w > 0)
        correct, total = correct + int(right.sum()), total + int((w > 0).sum())

    ev = FusedEvaluator(model, criterion, transform=transform, fuse_steps=4)
    for x, y, w in loader:
        ev.add(x, y, w)
    result = ev.finalize()
    assert result[1:] == (correct, total) and total == 52
    np.testing.assert_allclose(result[0], loss_sum, rtol=1e-5)
    for x, y, w in loader:
        ev.add(x, y, w)
    assert ev.finalize() == result

    jacc = JaxAccelerator(mesh=make_mesh(jax.devices("cpu")[:1]), seed=0)
    jmodule._tpuddp_initial_variables = (params, mstate)
    jmodel = jacc.prepare(jmodule)
    jmodel(np.zeros((1, 8, 8, 3), np.float32))  # the initial variables take their place
    jmodel.eval()
    jev = JaxFusedEvaluator(jmodel, jax_nn.CrossEntropyLoss(),
                            transform=jax.jit(jax_eval_transform(size=None)), fuse_steps=4)
    for x, y, w in JaxDataLoader(JaxSynthetic(n=52, shape=(8, 8, 3), seed=2), batch_size=8):
        jev.add(x, y, w)
    ref = jev.finalize()
    assert result[1:] == ref[1:]
    np.testing.assert_allclose(result[0], ref[0], rtol=1e-4)


def test_fused_evaluator_matches_jax_on_ragged_streams():
    """tests/test_accelerate.py:943: a ragged stream (8, 3 and 5 rows, the
    shape changing between groups) gives the JAX package's evaluator's
    result; both work the auto depth out again for each batch shape (the
    depths themselves are held against the JAX evaluator's in
    tests/test_torch_port_scan.py)."""
    ds_x = np.random.RandomState(3).randn(16, 8, 8, 3).astype(np.float32)
    ds_y = np.random.RandomState(4).randint(0, 10, 16)
    jmodule = JaxToyMLP(10, hidden=(16,))
    params, mstate = jmodule.init(jax.random.key(0), jnp.zeros((1, 8, 8, 3)))
    acc = Accelerator(seed=0, device="cpu")
    module = ToyMLP(8 * 8 * 3, 10, (16,))
    module.load_state_dict(state_dict_from_jax(
        "toy_mlp", jax.tree_util.tree_map(np.asarray, params), None))
    model = acc.prepare(module)
    model.eval()
    cuts = [(0, 8), (8, 11), (11, 16)]
    ev = FusedEvaluator(model, CrossEntropyLoss())
    for a, b in cuts:
        ev.add(ds_x[a:b], ds_y[a:b])
    result = ev.finalize()

    jacc = JaxAccelerator(mesh=make_mesh(jax.devices("cpu")[:1]), seed=0)
    jmodule._tpuddp_initial_variables = (params, mstate)
    jmodel = jacc.prepare(jmodule)
    jmodel(np.zeros((1, 8, 8, 3), np.float32))
    jmodel.eval()
    jev = JaxFusedEvaluator(jmodel, jax_nn.CrossEntropyLoss())
    for a, b in cuts:
        jev.add(ds_x[a:b], ds_y[a:b])
    ref = jev.finalize()
    assert result[1:] == ref[1:] and result[2] == 16
    np.testing.assert_allclose(result[0], ref[0], rtol=1e-4)


# ------------------------------------------------------- lazy losses ----

@pytest.mark.parametrize("fuse", [1, 4])
def test_superseded_backward_loss_refuses_silent_recompute(fuse):
    """tests/test_accelerate.py:262, at depth 1 and queued: a loss whose
    backward request was dropped (a second backward before step(), or
    zero_grad()) raises when read; a loss read before it was superseded
    keeps its value; a forward-only loss still computes."""
    acc, model, opt = _prepared(fuse, lr=0.1)
    criterion = CrossEntropyLoss()
    x, y = _batch()

    loss1 = criterion(model(x), y)
    acc.backward(loss1)
    loss2 = criterion(model(x), y)
    acc.backward(loss2)
    opt.step()
    with pytest.raises(RuntimeError, match="dropped"):
        loss1.item()
    assert loss2.item() > 0

    loss3 = criterion(model(x), y)
    acc.backward(loss3)
    opt.zero_grad()
    with pytest.raises(RuntimeError, match="dropped"):
        loss3.item()

    loss4 = criterion(model(x), y)
    acc.backward(loss4)
    v4 = loss4.item()
    loss5 = criterion(model(x), y)
    acc.backward(loss5)
    opt.step()
    assert loss4.item() == v4
    assert criterion(model(x), y).item() > 0


def test_fuse_queue_flushes_before_params_are_read():
    """tests/test_accelerate.py:300: with 2 of 4 steps queued, a forward,
    a queued loss's read and save_model each flush first; the queued losses
    are each step's own."""
    acc, model, opt = _prepared(4)
    x, _ = _batch()
    p0 = _params(model)
    losses = _steps(acc, model, opt, 2)
    assert opt.queued == 2 and all(l._value is None for l in losses)
    model.eval()
    model(x).value
    assert opt.queued == 0
    assert any(not torch.equal(a, b) for a, b in zip(_params(model), p0))
    assert losses[0].item() != losses[1].item()

    model.train()
    losses = _steps(acc, model, opt, 2)
    assert opt.queued == 2
    losses[1].item()
    assert opt.queued == 0


def test_params_read_flushes_fuse_queue(tmp_path):
    """tests/test_accelerate.py:351: parameters(), module, gather,
    save_model and save_state never see parameters that queued updates
    have not reached."""
    acc, model, opt = _prepared(4, seed=2)
    reads = [
        lambda: list(model.parameters()), lambda: model.module, lambda: acc.gather(torch.zeros(2)),
        lambda: acc.save_model(model, str(tmp_path)),
        lambda: acc.save_state(model, opt, str(tmp_path), epoch=0),
    ]
    for read in reads:
        p0 = _params(model)
        _steps(acc, model, opt, 2)
        assert opt.queued == 2
        read()
        assert opt.queued == 0
        assert any(not torch.equal(a, b) for a, b in zip(_params(model), p0))


def test_failed_flush_marks_queued_losses_dropped(monkeypatch):
    """tests/test_accelerate.py:377: when the flush fails, its losses are
    dropped: reading one raises rather than computing a forward against
    parameters the queued updates never reached."""
    acc, model, opt = _prepared(2, seed=3)
    (loss1,) = _steps(acc, model, opt, 1)
    monkeypatch.setattr(opt, "_run_eager", lambda q: (_ for _ in ()).throw(
        RuntimeError("simulated flush failure")))
    criterion = loss1._criterion
    x, y = _batch()
    loss2 = criterion(model(x), y)
    acc.backward(loss2)
    with pytest.raises(RuntimeError, match="simulated"):
        opt.step()
    assert opt.queued == 0
    for l in (loss1, loss2):
        assert l._queued_on is None
        with pytest.raises(RuntimeError, match="flush failed"):
            l.item()


@pytest.mark.parametrize("restore", ["load_model", "load_state"])
def test_restore_discards_queued_steps_without_executing(tmp_path, restore):
    """tests/test_accelerate.py:678: load_model and load_state drop the
    steps queued against the old weights without running them; their losses
    then raise."""
    acc, model, opt = _prepared(4, seed=11)
    acc.save_model(model, str(tmp_path))
    acc.save_state(model, opt, str(tmp_path), epoch=0)
    saved = _params(model)
    losses = _steps(acc, model, opt, 2)
    assert opt.queued == 2
    opt._run_eager = lambda q: (_ for _ in ()).throw(
        AssertionError("queued steps must be discarded, not run"))
    getattr(acc, restore)(model, *([opt] if restore == "load_state" else []), str(tmp_path))
    assert opt.queued == 0
    for a, b in zip(_params(model), saved):
        assert torch.equal(a, b)
    for l in losses:
        with pytest.raises(RuntimeError, match="discarded"):
            l.item()


# ------------------------------------------------------- the fuse depth --

def test_accumulation_and_fuse_steps_are_exclusive():
    """tests/test_accelerate.py:520: an explicit depth over 1 with
    accumulation is the JAX package's ValueError; auto yields to it."""
    mesh = make_mesh(jax.devices("cpu")[:1])
    with pytest.raises(ValueError, match="exclusive") as jax_err:
        JaxAccelerator(mesh=mesh, fuse_steps=4, gradient_accumulation_steps=2)
    with pytest.raises(ValueError, match="exclusive") as err:
        Accelerator(fuse_steps=4, gradient_accumulation_steps=2, device="cpu")
    assert str(err.value) == str(jax_err.value)
    assert Accelerator(fuse_steps="auto", gradient_accumulation_steps=2, device="cpu").fuse_steps \
        == JaxAccelerator(mesh=mesh, fuse_steps="auto", gradient_accumulation_steps=2).fuse_steps == 1


def test_auto_fuse_steps_resolves_by_model_size():
    """tests/test_accelerate.py:528: auto resolves once per optimizer, at
    its first step, to 32 for small batches, as the JAX package does; the
    step is queued and its loss read flushes."""
    acc, model, opt = _prepared("auto", seed=3, lr=0.1)
    assert acc.fuse_steps == "auto" and opt.fuse_depth is None
    (loss,) = _steps(acc, model, opt, 1)
    assert opt.fuse_depth == 32 == AUTO_FUSE_CAP and acc.fuse_steps == "auto"
    assert opt.queued == 1
    assert loss.item() > 0 and opt.queued == 0

    jacc = JaxAccelerator(mesh=make_mesh(jax.devices("cpu")[:1]), seed=3, fuse_steps="auto")
    jmodel, jopt = jacc.prepare(JaxToyMLP(hidden=(8,)), jax_optim.SGD(0.1))
    x, y = _batch()
    jacc.backward(jax_nn.CrossEntropyLoss()(jmodel(x), y))
    jopt.step()
    assert jopt._fuse == opt.fuse_depth


def test_auto_fuse_respects_staging_budget():
    """tests/test_accelerate.py:930: the auto depth is 32 capped by the
    256 MB staging budget over one batch's bytes, the JAX package's numbers;
    the optimizer resolves it over the batch it is given."""
    for nbytes in (None, 38_535_168, 400_000, 10**10):
        assert batching.resolve_fuse(nbytes, cap=AUTO_FUSE_CAP) == _resolve_auto_fuse(None, nbytes)
    assert batching.resolve_fuse(38_535_168, cap=AUTO_FUSE_CAP) == 6
    _, _, opt = _prepared("auto")
    big = torch.empty((128, 224, 224, 3), dtype=torch.bfloat16, device="meta")  # 38.5 MB
    assert opt._depth(big) == 6


def test_short_epoch_partial_queue_flushes_as_one_scan(monkeypatch):
    """tests/test_accelerate.py:568: 3 steps under a depth of 32 run as one
    flush of 3 when the losses are summed, each loss its own step's; the
    steps are bitwise the unfused ones."""
    acc, model, opt = _prepared(32, seed=4, lr=0.1)
    flushes = []
    run_eager = opt._run_eager
    monkeypatch.setattr(opt, "_run_eager", lambda q: (flushes.append(len(q)), run_eager(q)))
    losses = _steps(acc, model, opt, 3)
    assert opt.queued == 3 and flushes == []
    total = sum_losses(losses)
    assert flushes == [3] and opt.queued == 0
    assert losses[0].item() != losses[2].item()

    acc1, model1, opt1 = _prepared(1, seed=4, lr=0.1)
    unfused = _steps(acc1, model1, opt1, 3)
    assert torch.equal(sum_losses(unfused), total)
    assert [l.item() for l in unfused] == [l.item() for l in losses]
    for a, b in zip(_params(model1), _params(model)):
        assert torch.equal(a, b)


def test_a_change_of_criterion_or_shape_flushes_the_queue():
    """tests/test_accelerate.py:1048-1057: a new criterion or batch shape
    flushes the steps queued before it."""
    acc, model, opt = _prepared(8, seed=6, lr=0.1)
    _steps(acc, model, opt, 2)
    assert opt.queued == 2
    _steps(acc, model, opt, 1)  # a new criterion object
    assert opt.queued == 1
    x, y = _batch(n=4)
    acc.backward(CrossEntropyLoss()(model(x), y))
    opt.step()
    assert opt.queued == 1


def test_a_loss_read_before_step_applies_at_once():
    """tests/test_accelerate.py:1066-1090: a pending step's loss read before
    step() flushes the queue and runs that gradient; the step() after it
    applies the update at once, unqueued."""
    acc, model, opt = _prepared(4, seed=8, lr=0.1)
    _steps(acc, model, opt, 2)
    criterion = CrossEntropyLoss()
    x, y = _batch()
    loss = criterion(model(x), y)
    acc.backward(loss)
    assert opt.queued == 2
    value = loss.item()
    assert opt.queued == 0 and opt.updates == 2
    opt.step()
    assert opt.queued == 0 and opt.updates == 3 and loss.item() == value


# ---------------------------------------------- the host side of a replay --

def test_adam_replay_words_are_the_next_steps_launch_scalars():
    """A replayed Adam step's words are what the kernel's launch table
    would carry for that step (bias corrections of each leaf's own step
    count, float32 and bf16 noise words), and the replay advances each
    parameter's step count as the step would."""
    for dtype in (torch.float32, torch.bfloat16):
        params = [torch.nn.Parameter(torch.randn(n)) for n in (5, 0, 70)]
        opt = optim.Adam(params, lr=1e-3, state_dtype=dtype, leaf_index=[4, 1, 2])
        for p in params:
            p.grad = torch.randn(p.shape)
        opt.step()
        stepped = [[p for p in params if p.grad is not None]]
        words = opt._replay(stepped)
        assert [opt.state[p]["step"] for p in params] == [2, 2, 2]
        bcs = [fused_adam.bias_corrections(2, (0.9, 0.999))] * 3
        noise = ([tuple(fused_adam.noise_offset(2, s) for s in fused_adam.moment_salts(k))
                  for k in (4, 1, 2)] if dtype == torch.bfloat16 else None)
        (table,) = fused_adam.launch_tables([(16, 16, 16, 16)] * 3, [5, 0, 70], *zip(*bcs),
                                            noise=noise)
        assert len(words) == 1
        np.testing.assert_array_equal(words[0].view(np.uint32),
                                      fused_adam.table_scalars(table).view(np.uint32))
        assert len(words[0]) == 4 * 2  # the empty leaf has no row


def test_lamb_replay_words_are_the_inverse_bias_corrections(monkeypatch):
    """LAMB hands a replay ``1 / bc`` in float32 per parameter, advancing
    the step counts; a counting recorder (the warm-up) leaves its step the
    eager one; and its slotted arithmetic (multiply by the inverse) agrees
    with the eager step to float32 rounding on the CPU (on the card the
    eager host-scalar division is that multiply, and phase 9 of
    chip_smoke.py holds the two bitwise)."""
    torch.manual_seed(0)
    init = [torch.randn(6), torch.randn(3, 2)]
    grads = [[torch.randn_like(t) for t in init] for _ in range(2)]
    sides = []
    for count in (False, True):
        params = [torch.nn.Parameter(t.clone()) for t in init]
        opt = optim.LAMB(params, lr=1e-2, weight_decay=1e-2)
        for step, gs in enumerate(grads):
            for p, g in zip(params, gs):
                p.grad = g.clone()
            if count and step == 1:
                with device_scalars.Recorder("cpu") as counter:
                    opt.step()
                assert counter.words == 4 and not counter.slots
            else:
                opt.step()
        sides.append((params, opt))
    for a, b in zip(sides[0][0], sides[1][0]):
        assert torch.equal(a, b)
    params, opt = sides[1]
    (words,) = opt._replay([params])
    bcs = [fused_adam.bias_corrections(3, (0.9, 0.999))] * 2
    np.testing.assert_array_equal(words, (np.float32(1) / np.float32(bcs)).reshape(-1))
    assert [opt.state[p]["step"] for p in params] == [3, 3]

    for p in params:
        p.grad = torch.ones_like(p)
    before = [p.detach().clone() for p in params]
    state = {p: {k: v.clone() if torch.is_tensor(v) else v for k, v in opt.state[p].items()}
             for p in params}
    opt.step()  # eager, step 4
    eager = [p.detach().clone() for p in params]

    class Slots:  # a capture whose slots hold their words at once
        def slot(self, words):
            return torch.from_numpy(np.array(words, dtype=np.float32))

    for p, b in zip(params, before):
        p.data.copy_(b)
        opt.state[p].update(state[p])
    monkeypatch.setattr(device_scalars, "active", Slots)
    opt.step()
    for a, b in zip(params, eager):
        torch.testing.assert_close(a.detach(), b, rtol=1e-6, atol=1e-7)


def test_graph_signature_tells_apart_what_a_capture_holds_fixed():
    """A captured graph is replayed only for a flush of its own signature:
    other tensors of the same shapes share it; another row count, dtype,
    criterion, flip-mask presence, length, learning rate or clip does not."""
    from tpuddp_torch.accelerate import _Request
    from tpuddp_torch.training.graphs import signature

    acc, model, opt = _prepared(4)
    crit = CrossEntropyLoss()

    def queue(rows=8, criterion=crit, mask=False, k=4, dtype=torch.float32):
        return [_Request(torch.zeros(rows, HW, HW, 3, dtype=dtype),
                         torch.zeros(rows, dtype=torch.int64), torch.ones(rows), criterion, i, None,
                         torch.zeros(rows, dtype=torch.bool) if mask else None) for i in range(k)]

    base = signature(opt, queue())
    assert signature(opt, queue()) == base
    keys = [signature(opt, q) for q in (
        queue(rows=1), queue(dtype=torch.float64), queue(criterion=CrossEntropyLoss()),
        queue(mask=True), queue(k=3))]
    assert base not in keys and len(set(keys)) == len(keys)
    opt.optimizer.param_groups[0]["lr"] = 0.25
    assert signature(opt, queue()) != base
    opt.optimizer.param_groups[0]["lr"] = 0.5
    acc.clip_grad_norm = 1.0
    assert signature(opt, queue()) != base
    acc.clip_grad_norm = None
    assert signature(opt, queue()) == base


def test_recorder_refresh_writes_each_slot_and_refuses_a_mismatch():
    """A capture's slots refill from its replay callbacks in order; a
    replay that returns other sizes, or a capture that outgrows its
    warm-up's count, raises."""
    with device_scalars.Recorder("cpu", capacity=12) as rec:
        a = rec.slot(np.array([1, 2], np.float32))
        b = rec.slot(np.array([3, 4, 5, 6, 7], np.float32))
        device_scalars.on_replay(lambda: [np.array([9, 8], np.float32)])
        device_scalars.on_replay(lambda: [np.arange(5, dtype=np.float32)])
    assert rec.words == 12 and (a.shape, b.shape) == ((2,), (5,))
    assert a.data_ptr() - rec.buffer.data_ptr() == 0 and b.data_ptr() - rec.buffer.data_ptr() == 16
    np.testing.assert_array_equal(rec.image[:2], [1, 2])
    rec.refresh()
    np.testing.assert_array_equal(rec.image[[0, 1, 4, 5, 6, 7, 8]], [9, 8, 0, 1, 2, 3, 4])
    rec.callbacks.append(lambda: [np.zeros(1, np.float32)])
    with pytest.raises(RuntimeError, match="scalar arrays"):
        rec.refresh()
    with device_scalars.Recorder("cpu", capacity=4) as rec, pytest.raises(RuntimeError, match="warm-up"):
        rec.slot(np.zeros(5, np.float32))
    assert not device_scalars.capturing()


def test_flush_clock_spreads_each_group_over_its_steps():
    """step_ms under fusion: one time per flush, divided by the steps it
    ran; unfused, one time per step."""
    clock = StepClock(torch.device("cpu"))
    clock.marks = [0.0, 0.032, 0.045]
    clock.groups = [32, 13]
    ms = clock.step_ms()
    assert len(ms) == 45
    np.testing.assert_allclose(ms[:32], [1.0] * 32)
    np.testing.assert_allclose(ms[32:], [1.0] * 13)


# ------------------------------------------------------------ on the card --

@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["adam", "lamb"])
def test_graph_replay_is_bitwise_the_eager_queue_on_the_card(card, opt):
    """Three flushes of 4 steps from one state, through CUDA-graph replay
    (warm-up, capture, replay) and through the eager queue: parameters,
    optimizer state and losses bitwise; one Adam-kernel launch per update
    through the replays."""
    from tpuddp_torch.training import graphs

    x, y = _batch()
    out = {}
    for replay in (False, True):
        acc = Accelerator(seed=1, fuse_steps=4)
        torch.manual_seed(1)
        module = ToyMLP(HW * HW * 3, 10, (8,))
        optimizer = (optim.Adam(module.parameters(), lr=1e-2) if opt == "adam"
                     else optim.LAMB(module.parameters(), lr=1e-2, weight_decay=1e-2))
        model, prepared = acc.prepare(module, optimizer)
        prepared._graph_replay = replay
        launches = fused_adam.kernel.launches
        graphs.reset_stats()
        losses = _steps(acc, model, prepared, 12)
        values = [l.item() for l in losses]
        state = [p.detach().clone() for p in model.parameters()]
        state += [t.clone() for st in optimizer.state.values() for t in st.values()
                  if torch.is_tensor(t)]
        out[replay] = (values, state, fused_adam.kernel.launches - launches, dict(graphs.stats))
    (eager, s_eager, n_eager, _), (replayed, s_replay, n_replay, stats) = out[False], out[True]
    assert eager == replayed
    for a, b in zip(s_eager, s_replay):
        assert torch.equal(a, b)
    assert n_eager == n_replay == (12 if opt == "adam" else 0)
    assert (stats["captures"], stats["replays"]) == (1, 2)


@pytest.mark.cuda
def test_flushes_of_one_length_replay_the_graph_of_their_signature_on_the_card(card):
    """Flushes of 4 steps alternating between two signatures of one length
    (8 rows under the mean criterion, 5 rows under the sum criterion), three
    of each: the replays are bitwise the eager queue, with one capture per
    signature and one Adam-kernel launch per update."""
    from tpuddp_torch.training import graphs

    mean, total = CrossEntropyLoss(), CrossEntropyLoss(reduction="sum")
    flushes = [(_batch(seed=s, n=8 if s % 2 == 0 else 5), mean if s % 2 == 0 else total)
               for s in range(6)]
    out = {}
    for replay in (False, True):
        acc = Accelerator(seed=1, fuse_steps=4)
        torch.manual_seed(1)
        module = ToyMLP(HW * HW * 3, 10, (8,))
        model, prepared = acc.prepare(module, optim.Adam(module.parameters(), lr=1e-2))
        prepared._graph_replay = replay
        fused_adam.kernel.reset_launches()
        graphs.reset_stats()
        losses = []
        for (x, y), criterion in flushes:
            for _ in range(4):
                prepared.zero_grad()
                loss = criterion(model(x), y)
                acc.backward(loss)
                prepared.step()
                losses.append(loss)
        values = [l.item() for l in losses]
        state = [p.detach().clone() for p in model.parameters()]
        state += [t.clone() for st in prepared.optimizer.state.values() for t in st.values()
                  if torch.is_tensor(t)]
        out[replay] = (values, state, fused_adam.kernel.launches, dict(graphs.stats))
    (eager, s_eager, n_eager, _), (replayed, s_replay, n_replay, stats) = out[False], out[True]
    assert eager == replayed
    for a, b in zip(s_eager, s_replay):
        assert torch.equal(a, b)
    assert n_eager == n_replay == 24
    assert (stats["captures"], stats["replays"]) == (2, 4)
