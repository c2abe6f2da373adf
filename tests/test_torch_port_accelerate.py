"""The port's managed path (tpuddp_torch.accelerate, train_accelerate)
against the JAX package's Accelerator, on the CPU: 3 steps of toy_mlp and of
toy_cnn with BatchNorm at world 1 (in-process against a 1-device mesh) and
world 2 (two Gloo processes against a 2-device mesh, with a ragged batch that
shows the global-weighted gradient and the global BatchNorm statistics),
managed == native at world 1, the call-order contracts, the fuse_steps and
deferred_metrics resolutions (the one refusal: a depth over 1 with
accumulation), the loaders, save_model and
save_state, and the entry point end to end on 2 Gloo processes.

Inputs come from numpy seeds, weights from the JAX init through
models/convert.py; no flip (the two packages draw different masks).
Tolerances, float32: params rtol 1e-4 / atol 1e-5, losses rtol 1e-4 — two
libraries summing in another order, over at most 3 Adam steps."""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp import optim as jax_optim
from tpuddp.accelerate import Accelerator as JaxAccelerator
from tpuddp.data import DataLoader as JaxDataLoader
from tpuddp.data.synthetic import SyntheticClassification as JaxSynthetic
from tpuddp.models import ToyCNN as JaxToyCNN
from tpuddp.models import ToyMLP as JaxToyMLP
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.nn.core import Context
from tpuddp.parallel import make_mesh

from tpuddp_torch import config as cfg
from tpuddp_torch.accelerate import (
    Accelerator, LazyForward, LazyLoss, PreparedModel, PreparedOptimizer, sum_losses,
)
from tpuddp_torch.data import DataLoader, ShardedDataLoader
from tpuddp_torch.data.synthetic import SyntheticClassification
from tpuddp_torch.models import ToyCNN, ToyMLP
from tpuddp_torch.models.convert import jax_from_state_dict, jax_leaf_index, state_dict_from_jax
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.nn.norm import BatchNorm
from tpuddp_torch.optim import Adam
from tpuddp_torch.parallel.ddp import DistributedDataParallel
from tpuddp_torch.training import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _torch_port_accel_worker as worker_cfg  # noqa: E402

P_RTOL, P_ATOL = 1e-4, 1e-5
LOSS_RTOL = 1e-4
SPAWN_TIMEOUT_S = 180
MODELS = ("toy_mlp", "toy_cnn")
GLOBAL = 16  # rows per global batch: 8 per process at world 2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    env.pop("TPUDDP_WORLD_SIZE", None)
    return env


def jax_model(name):
    if name == "toy_mlp":
        return JaxToyMLP(10, hidden=worker_cfg.HIDDEN)
    return JaxToyCNN(num_classes=10, widths=worker_cfg.WIDTHS)


def port_model(name):
    if name == "toy_mlp":
        return ToyMLP(int(np.prod(worker_cfg.SHAPE)), 10, worker_cfg.HIDDEN)
    return ToyCNN(10, worker_cfg.WIDTHS, input_shape=worker_cfg.SHAPE)


def to_state_dict(name, params, mstate):
    return state_dict_from_jax(name, _np_tree(params), _np_tree(mstate) if name == "toy_cnn" else None)


@pytest.fixture(scope="module")
def inits():
    """Each model's JAX init, as ``(params, model_state, state_dict)``."""
    out = {}
    for name in MODELS:
        params, mstate = jax_model(name).init(jax.random.key(3), jnp.zeros((1, *worker_cfg.SHAPE)))
        out[name] = (params, mstate, to_state_dict(name, params, mstate))
    return out


def make_batches(seed, real_rows=((8, 2), (8, 8), (5, 8))):
    """Global batches of 16 rows, the i-th with ``real_rows[i]`` real rows
    in each half (the half a process of a world of 2 takes)."""
    rng = np.random.RandomState(seed)
    out = []
    for real in real_rows:
        x = rng.randn(GLOBAL, *worker_cfg.SHAPE).astype(np.float32)
        y = rng.randint(0, 10, GLOBAL).astype(np.int64)
        w = np.concatenate([(np.arange(GLOBAL // 2) < r) for r in real]).astype(np.float32)
        out.append((x, y, w))
    return out


def jax_managed(name, inits, devices, batches, accum=1):
    """The JAX Accelerator's losses and state_dicts after each step, and
    after the final ``flush_accumulation``."""
    params, mstate, _ = inits[name]
    module = jax_model(name)
    module._tpuddp_initial_variables = (params, mstate)
    acc = JaxAccelerator(mesh=make_mesh(devices), seed=0, gradient_accumulation_steps=accum)
    model, opt = acc.prepare(module, jax_optim.Adam(worker_cfg.LR))
    criterion = JaxCrossEntropyLoss()
    losses, states = [], []
    for x, y, w in batches:
        opt.zero_grad()
        loss = criterion(model(x), y.astype(np.int32), w)
        acc.backward(loss)
        opt.step()
        losses.append(loss.item())
        states.append(to_state_dict(name, model.params, model.model_state))
    opt.flush_accumulation()
    return losses, states, to_state_dict(name, model.params, model.model_state)


def port_managed(name, sd, batches, accum=1):
    acc = Accelerator(seed=0, gradient_accumulation_steps=accum, device="cpu")
    module = port_model(name)
    module.load_state_dict(sd)
    model, opt = acc.prepare(module, Adam(module.parameters(), lr=worker_cfg.LR))
    criterion = CrossEntropyLoss()
    losses, states = [], []
    for x, y, w in batches:
        opt.zero_grad()
        loss = criterion(model(x), y, w)
        acc.backward(loss)
        opt.step()
        losses.append(loss.item())
        states.append({k: v.clone() for k, v in model.module.state_dict().items()})
    opt.flush_accumulation()
    return losses, states, model.module.state_dict()


def assert_state_close(got, ref, what=""):
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]), rtol=P_RTOL,
                                   atol=P_ATOL, err_msg=f"{what} {k}")


# ------------------------------------------------------------ world 1 ----

@pytest.mark.parametrize("name", MODELS)
def test_managed_matches_jax_accelerator_world_1(cpu_devices, inits, name):
    batches = make_batches(1)
    ref_losses, ref_states, _ = jax_managed(name, inits, cpu_devices[:1], batches)
    losses, states, _ = port_managed(name, inits[name][2], batches)
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    for i, (got, ref) in enumerate(zip(states, ref_states)):
        assert_state_close(got, ref, f"step {i}")


@pytest.mark.parametrize("name", MODELS)
def test_managed_equals_native_at_world_1(inits, name):
    """The two APIs, one state, three full batches: the same trajectory
    (``tests/test_accelerate.py:92-135``)."""
    batches = make_batches(2, real_rows=((8, 8),) * 3)
    _, states, _ = port_managed(name, inits[name][2], batches)
    module = port_model(name)
    module.load_state_dict(inits[name][2])
    ddp = DistributedDataParallel(module, Adam(module.parameters(), lr=worker_cfg.LR),
                                  CrossEntropyLoss(), device="cpu")
    for i, batch in enumerate(batches):
        ddp.train_step(batch)
        assert_state_close(states[i], ddp.model.state_dict(), f"step {i}")


# ------------------------------------------------------------ world 2 ----

WORLD2_RUNS = [("toy_mlp", 1), ("toy_cnn", 1), ("toy_cnn", 2)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory, inits):
    """One 2-process Gloo run of every ``WORLD2_RUNS`` entry on the batches
    of ``make_batches(5)``; returns each run's per-rank outputs."""
    work = tmp_path_factory.mktemp("accel_world2")
    runs = []
    for name, accum in WORLD2_RUNS:
        run = f"{name}_a{accum}"
        np.savez(work / f"{run}_init.npz", **{k: v.numpy() for k, v in inits[name][2].items()})
        np.savez(work / f"{run}_batches.npz", **{
            f"{k}{i}": a for i, b in enumerate(make_batches(5)) for k, a in zip("xyw", b)
        })
        runs.append({"name": run, "mode": "managed", "model": name, "accum": accum})
    (work / "run.json").write_text(json.dumps(runs))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_port_accel_worker.py"), str(work)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=_env(),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {(name, accum): [dict(np.load(work / f"{name}_a{accum}_{r}.npz")) for r in range(2)]
            for name, accum in WORLD2_RUNS}


def _steps(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


@pytest.mark.parametrize("name,accum", WORLD2_RUNS, ids=[f"{n}-A{a}" for n, a in WORLD2_RUNS])
def test_managed_matches_jax_accelerator_world_2(cpu_devices, inits, world2, name, accum):
    """Rank 1 starts from perturbed weights, so agreement also shows the
    broadcast at prepare. Batch 0 is ragged (8 and 2 real rows), batch 2
    too (5 and 8); with A=2 the third batch is a partial cycle that the
    final flush applies."""
    batches = make_batches(5)
    ref_losses, ref_states, ref_final = jax_managed(name, inits, cpu_devices[:2], batches, accum)
    ranks = world2[(name, accum)]
    for k in ranks[0]:  # every process holds the same state and global loss
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    out = ranks[0]
    np.testing.assert_allclose([float(out[f"loss{i}"]) for i in range(3)], ref_losses,
                               rtol=LOSS_RTOL)
    for i, ref in enumerate(ref_states):
        assert_state_close(_steps(out, f"step{i}/"), ref, f"step {i}")
    assert_state_close(_steps(out, "final/"), ref_final, "final")


def test_ragged_world_2_is_the_global_weighted_gradient(inits, world2):
    """On the ragged first batch (8 and 2 real rows) the gradient that
    ``backward`` leaves is the global batch's, ``sum n_r g_r / sum n_r``,
    which differs from the native step's mean of the two processes' means by
    far more than the tolerance."""
    params, mstate, _ = inits["toy_mlp"]
    x, y, w = make_batches(5)[0]
    module = jax_model("toy_mlp")

    def grad(rows):
        def loss_fn(p):
            logits, _ = module.apply(p, mstate, jnp.asarray(x[rows]), Context(train=True))
            return JaxCrossEntropyLoss()(logits, jnp.asarray(y[rows], jnp.int32), jnp.asarray(w[rows]))
        return to_state_dict("toy_mlp", jax.grad(loss_fn)(params), None)

    global_grad = grad(slice(None))
    halves = [grad(slice(0, 8)), grad(slice(8, 16))]
    got = _steps(world2[("toy_mlp", 1)][0], "grad0/")
    assert_state_close(got, global_grad, "grad")
    gap = max(float(np.max(np.abs(got[k] - (halves[0][k] + halves[1][k]).numpy() / 2))) for k in got)
    assert gap > 100 * P_ATOL, gap


def test_global_batchnorm_statistics_at_world_2(world2, inits):
    """The managed prepare syncs every BatchNorm: after each step both
    processes hold the same running statistics (compared with the JAX
    global-batch statistics in the world-2 test) and they moved."""
    ranks = world2[("toy_cnn", 1)]
    init = inits["toy_cnn"][2]
    for key in ("1.running_mean", "1.running_var", "5.running_mean", "5.running_var"):
        np.testing.assert_array_equal(ranks[0][f"step0/{key}"], ranks[1][f"step0/{key}"])
        assert not np.array_equal(ranks[0][f"step0/{key}"], init[key].numpy())


# ------------------------------------------------------- call order ----

def _prepared(name="toy_mlp", accum=1, sd=None):
    acc = Accelerator(seed=0, gradient_accumulation_steps=accum, device="cpu")
    module = port_model(name)
    if sd is not None:
        module.load_state_dict(sd)
    model, opt = acc.prepare(module, Adam(module.parameters(), lr=worker_cfg.LR))
    return acc, model, opt


def test_prepare_wraps_and_the_lazy_bridge():
    acc, model, opt = _prepared("toy_cnn")
    assert isinstance(model, PreparedModel) and isinstance(opt, PreparedOptimizer)
    assert all(m.sync for m in model.module.modules() if isinstance(m, BatchNorm))
    x, y, w = make_batches(3)[0]
    out = model(x)
    assert isinstance(out, LazyForward) and out._logits is None  # nothing ran yet
    loss = CrossEntropyLoss()(out, y, w)
    assert isinstance(loss, LazyLoss)
    acc.backward(loss)
    assert out.argmax().shape == (GLOBAL,)  # the backward's logits, no second forward
    before = [p.detach().clone() for p in model.parameters()]
    opt.step()
    assert any(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
    assert opt.updates == 1 and all(p.grad is None for p in model.parameters())
    with pytest.raises(TypeError):
        acc.prepare(42)
    with pytest.raises(TypeError):
        acc.backward(torch.zeros(()))


def test_step_without_backward_raises():
    _, model, opt = _prepared()
    with pytest.raises(RuntimeError, match="backward"):
        opt.step()


def test_second_backward_drops_the_first_loss(inits):
    sd = inits["toy_mlp"][2]
    b1, b2 = make_batches(4)[:2]
    acc, model, opt = _prepared(sd=sd)
    crit = CrossEntropyLoss()
    first = crit(model(b1[0]), b1[1], b1[2])
    acc.backward(first)
    second = crit(model(b2[0]), b2[1], b2[2])
    acc.backward(second)
    opt.step()
    with pytest.raises(RuntimeError, match="dropped"):
        first.item()
    only_losses, _, only = port_managed("toy_mlp", sd, [b2])  # the second's update alone
    assert_state_close(model.module.state_dict(), only)
    np.testing.assert_allclose(second.item(), only_losses[0], rtol=1e-6)


def test_second_backward_under_accumulation_raises():
    acc, model, opt = _prepared(accum=2)
    x, y, w = make_batches(4)[0]
    acc.backward(CrossEntropyLoss()(model(x), y, w))
    with pytest.raises(RuntimeError, match="gradient accumulation"):
        acc.backward(CrossEntropyLoss()(model(x), y, w))


def test_zero_grad_drops_a_staged_step_and_is_otherwise_a_no_op():
    acc, model, opt = _prepared()
    before = [p.detach().clone() for p in model.parameters()]
    opt.zero_grad()  # nothing staged: nothing happens
    x, y, w = make_batches(4)[0]
    loss = CrossEntropyLoss()(model(x), y, w)
    acc.backward(loss)
    opt.zero_grad()
    with pytest.raises(RuntimeError, match="dropped"):
        loss.item()
    with pytest.raises(RuntimeError, match="backward"):
        opt.step()
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))
    read = CrossEntropyLoss()(model(x), y, w)
    acc.backward(read)
    value = read.item()  # read before the drop: it stays readable
    opt.zero_grad()
    assert read.item() == value


def test_forward_only_reads_leave_the_buffers_alone():
    """``loss.item()`` without a backward runs a forward only; in train mode
    its BatchNorm statistics are discarded, as the JAX package discards
    them."""
    acc, model, _ = _prepared("toy_cnn")
    x, y, w = make_batches(4)[0]
    buffers = [b.clone() for b in model.module.buffers()]
    value = CrossEntropyLoss()(model(x), y, w).item()
    assert np.isfinite(value)
    assert all(torch.equal(a, b) for a, b in zip(buffers, model.module.buffers()))
    model.eval()
    assert np.asarray(model(x)).shape == (GLOBAL, 10)


def test_sum_losses_and_topology():
    acc, model, opt = _prepared()
    losses = []
    for x, y, w in make_batches(6):
        loss = CrossEntropyLoss()(model(x), y, w)
        acc.backward(loss)
        opt.step()
        losses.append(loss)
    np.testing.assert_allclose(float(sum_losses(losses)), sum(l.item() for l in losses), rtol=1e-6)
    assert float(sum_losses([])) == 0.0
    assert (acc.num_processes, acc.process_index, acc.is_main_process) == (1, 0, True)
    assert acc.is_local_main_process and acc.device == torch.device("cpu")
    assert torch.equal(acc.gather(torch.arange(3)), torch.arange(3))
    acc.wait_for_everyone()
    g1, g2 = acc.next_rng_key(), acc.next_rng_key()
    assert not torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))


def test_accelerator_defaults_to_cuda_and_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from tpuddp_torch.parallel.backend import BackendUnavailableError

    with pytest.raises(BackendUnavailableError, match="no GPU"):
        Accelerator()


# ------------------------------------------- fuse_steps, deferred_metrics --

def test_fuse_steps_resolutions_match_jax(cpu_devices):
    mesh = make_mesh(cpu_devices[:1])
    assert Accelerator(fuse_steps="auto", gradient_accumulation_steps=2, device="cpu").fuse_steps \
        == JaxAccelerator(mesh=mesh, fuse_steps="auto", gradient_accumulation_steps=2).fuse_steps == 1
    assert Accelerator(device="cpu").fuse_steps == JaxAccelerator(mesh=mesh).fuse_steps == 1
    with pytest.raises(ValueError) as jax_err:
        JaxAccelerator(mesh=mesh, fuse_steps=4, gradient_accumulation_steps=2)
    with pytest.raises(ValueError) as err:
        Accelerator(fuse_steps=4, gradient_accumulation_steps=2, device="cpu")
    assert str(err.value) == str(jax_err.value)
    for fuse in (4, "auto"):  # the JAX package queues K > 1 steps here; so does the port
        assert Accelerator(fuse_steps=fuse, device="cpu").fuse_steps \
            == JaxAccelerator(mesh=mesh, fuse_steps=fuse).fuse_steps == fuse


@pytest.mark.parametrize("training,fuse", [
    ({}, 1),
    ({"deferred_metrics": True, "fuse_steps": 1}, 1),
    ({"deferred_metrics": True, "gradient_accumulation_steps": 2}, 1),
    ({"fuse_steps": "auto", "gradient_accumulation_steps": 4}, 1),
    ({"deferred_metrics": True}, "auto"),
    ({"deferred_metrics": True, "fuse_steps": "auto"}, "auto"),
    ({"fuse_steps": 2}, 2),
])
def test_accepted_fuse_and_deferred_settings(training, fuse):
    t = cfg.training_config({"training": training})
    assert cfg.resolve_fuse_steps(
        t["fuse_steps"], t["gradient_accumulation_steps"], t["deferred_metrics"]) == fuse


@pytest.mark.parametrize("training,error", [
    ({"fuse_steps": 2, "gradient_accumulation_steps": 2}, ValueError),
])
def test_refused_fuse_and_deferred_settings(training, error):
    with pytest.raises(error, match="mutually"):
        cfg.training_config({"training": training})


# ------------------------------------------------------------- loaders ----

@pytest.mark.parametrize("shuffle", [False, True])
def test_dataloader_matches_jax(shuffle):
    ds_j = JaxSynthetic(n=37, shape=(4, 4, 3), seed=2)
    ds_t = SyntheticClassification(n=37, shape=(4, 4, 3), seed=2)
    ref, ours = JaxDataLoader(ds_j, 8, shuffle=shuffle, seed=5), DataLoader(ds_t, 8, shuffle=shuffle, seed=5)
    for epoch in (0, 1):
        ref.set_epoch(epoch)
        ours.set_epoch(epoch)
        assert len(ours) == len(ref) == 5
        for (xr, yr, wr), (x, y, w) in zip(ref, ours):
            np.testing.assert_array_equal(w, wr)
            real = wr > 0  # padded rows: the JAX gather fills zeros, the port row 0
            np.testing.assert_array_equal(x[real], xr[real])
            np.testing.assert_array_equal(y, yr)


def test_prepare_shards_a_dataloader_and_leaves_others():
    acc = Accelerator(seed=0, device="cpu")
    ds = SyntheticClassification(n=40, shape=(4, 4, 3), seed=1)
    train = DataLoader(ds, 8, shuffle=True, seed=3)
    module = ToyMLP(48, 10, (4,))
    model, opt, prepared = acc.prepare(module, Adam(module.parameters()), train)
    assert isinstance(prepared, ShardedDataLoader)
    assert (prepared.batch_size, prepared.world_size, prepared.rank) == (8, 1, 0)
    assert prepared.sampler.shuffle and prepared.sampler.seed == 3
    sharded = ShardedDataLoader(ds, 8, 0, 1)
    assert acc.prepare(sharded) is sharded
    with pytest.raises(ValueError, match="no model"):
        acc.prepare(Adam(ToyMLP(48, 10, (4,)).parameters()))


# --------------------------------------------------------- checkpoints ----

def test_save_model_and_save_state_contents(tmp_path, inits):
    """model.npz and state_{epoch}.npz hold the JAX package's managed keys
    (tpuddp/accelerate.py:1559-1570, 1636-1651), in its layouts."""
    acc, model, opt = _prepared("toy_cnn", sd=inits["toy_cnn"][2])
    x, y, w = make_batches(7)[0]
    acc.backward(CrossEntropyLoss()(model(x), y, w))
    opt.step()
    path = acc.save_model(model, str(tmp_path))
    assert path == str(tmp_path / "model.npz") and ckpt.verify_file(path)
    params, mstate = jax_from_state_dict("toy_cnn", model.module.state_dict())
    want = {f"['params'][{i}]['{k}']": a for i, layer in enumerate(params) for k, a in (layer or {}).items()}
    want.update({f"['model_state'][{i}]['{k}']": a
                 for i, layer in enumerate(mstate) for k, a in (layer or {}).items()})
    with np.load(path) as data:
        assert sorted(data.files) == sorted(want)
        for k, a in want.items():
            np.testing.assert_array_equal(data[k], a)
    path = acc.save_state(model, opt, str(tmp_path), epoch=3)
    assert path == str(tmp_path / "state_3.npz") and ckpt.verify_file(path)
    with np.load(path) as data:
        assert int(data["__meta__epoch"]) == 3 and int(data["__meta__completed"]) == 1
        assert int(data["['opt_state'].step"]) == 1 and data["['opt_state'].step"].dtype == np.int32
        assert int(data["['bwd_counter']"]) == 1 and data["['bwd_counter']"].dtype == np.int64
        assert data["__prngkey__['rng_key']"].dtype == np.uint32
        moments = {n: opt.optimizer.state[p]["exp_avg_sq"] for n, p in model.module.named_parameters()}
        v, _ = jax_from_state_dict("toy_cnn", moments)
        np.testing.assert_array_equal(data["['opt_state'].v[0]['weight']"], v[0]["weight"])
        np.testing.assert_array_equal(data["['opt_state'].v[1]['scale']"], v[1]["scale"])
        record = json.loads(str(data[ckpt.RNG_KEY]))
        assert record[0]["generator"] == acc.generator.get_state().numpy().tobytes().hex()
    other = port_model("toy_cnn")
    assert ckpt.load(path, other, layout=ckpt.MANAGED)["epoch"] == 3  # the weights read back
    assert_state_close(other.state_dict(), model.module.state_dict())


def test_save_state_stores_bf16_moments_as_bits(tmp_path):
    acc = Accelerator(seed=0, device="cpu")
    module = port_model("toy_mlp")
    leaf = jax_leaf_index("toy_mlp", module)
    adam = Adam(module.parameters(), state_dtype="bfloat16",
                leaf_index=[leaf[n] for n, _ in module.named_parameters()])
    model, opt = acc.prepare(module, adam)
    x, y, w = make_batches(8)[0]
    acc.backward(CrossEntropyLoss()(model(x), y, w))
    opt.step()
    with np.load(acc.save_state(model, opt, str(tmp_path), epoch=0)) as data:
        bits = data["__bf16__['opt_state'].m[1]['weight']"]
        assert bits.dtype == np.uint16 and "['opt_state'].m[1]['weight']" not in data.files
        want = adam.state[module[1].weight]["exp_avg"].T  # (out, in) -> (in, out)
        assert torch.equal(torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16), want)


def test_save_state_refuses_a_partial_accumulation_cycle(tmp_path):
    acc, model, opt = _prepared(accum=2)
    x, y, w = make_batches(9)[0]
    acc.backward(CrossEntropyLoss()(model(x), y, w))
    opt.step()
    assert opt.updates == 0
    with pytest.raises(RuntimeError, match="mid-gradient-accumulation-cycle"):
        acc.save_state(model, opt, str(tmp_path))
    assert not os.listdir(tmp_path)
    opt.flush_accumulation()
    assert opt.updates == 1
    assert ckpt.verify_file(acc.save_state(model, opt, str(tmp_path)))


# --------------------------------------------------------- entry point ----

def test_entry_point_two_gloo_processes(tmp_path):
    out = tmp_path / "out"
    settings = tmp_path / "s.yaml"
    settings.write_text(
        f"out_dir: {out}\n"
        "local: {device: cpu, gpu: {num_gpus: 2}}\n"
        "training: {model: toy_mlp, data_root: /nonexistent, synthetic_n: [100, 40],\n"
        "           train_batch_size: 16, test_batch_size: 16, num_epochs: 2,\n"
        "           checkpoint_epoch: 5, image_size: null, seed: 0,\n"
        "           gradient_accumulation_steps: 2, deferred_metrics: true}\n"
    )
    proc = subprocess.run(
        [sys.executable, "-m", "tpuddp_torch.train_accelerate", "--settings_file", str(settings)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=_env(), cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    epoch_lines = [l for l in lines if l.startswith("Epoch ")]
    assert len(epoch_lines) == 2  # process 0 only
    for e, line in enumerate(epoch_lines, 1):
        assert re.fullmatch(
            rf"Epoch {e}/2, Train Loss: \d+\.\d{{4}}, Test Loss: \d+\.\d{{4}}, "
            r"Test Accuracy: \d+\.\d{2}%", line), line
    assert lines.count("Finished Training.") == 1
    rows = [json.loads(l) for l in (out / "history.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0, 1]
    for r in rows:
        assert (r["api"], r["grad_accumulation"], r["fuse_steps"], r["world_size"]) == ("managed", 2, 1, 2)
        # 50 rows per process in batches of 16: 4 steps, 2 updates; the
        # unprepared test loader: all 40 rows on every process
        assert len(r["step_ms"]) == 4 and r["updates"] == 2
        assert (r["train_samples"], r["test_samples"]) == (100, 40)
    # checkpoint_epoch 5: epoch 0 only (quirk Q6)
    assert ckpt.verify_file(str(out / "model.npz")) and ckpt.verify_file(str(out / "state_0.npz"))
    assert not (out / "state_1.npz").exists()
    with np.load(out / "state_0.npz") as data:
        assert {ckpt.RNG_KEY, "['opt_state'].m[1]['weight']", "['bwd_counter']"} <= set(data.files)
        assert len(json.loads(str(data[ckpt.RNG_KEY]))) == 2  # both processes' streams
